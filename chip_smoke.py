"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line; each group
starts with a line of the script's seconds so far):
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
     ViT-L-14-336's 577, the cost of the one-key tail chunk; bf16 at the
     single-image scorer's [4, 577, 3072]), K2 (also at
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
     K10 at [32|8, 16, 577, 64], and K5 with RoPE at PE-Core-G14-448's shape;
     then the shapes of phases 24-29: K1 bf16 at head dims 80, 88, 104 and
     112 ([16, 257, 3w]), K1 with RoPE on a cls row at EVA02-L-14-336's
     [32, 577, 3072], K4 at d=80 [16, 577, 3840] and with RoPE at
     PE-Core-G14-448 int8_static's [16, 1024, 4608], K2 at [18464, 1024],
     [9232, 1280], [4112, 1408] and [16384, 1536], K6 ln and gelu_tanh and K1
     quant_out at SO400M-384 hybrid's 4 images; the shards of phases 36-37;
     and phase 44's shapes: K1 bf16 at entry()'s [8, 257, 3072], at the dry
     run's tiny shards (bf16 and float32 [16, 17, 96], bf16 with RoPE [2, 17,
     192], bf16 [8, 17, 192]) and K2 at [34, 128],
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
 16. stage 4 at the reference's label-set size: 9,400 rows of width 768 x 2
     crops in a float16 store, labelled 0-9 from a latent the crops carry;
     the train CLI on the card in the default configuration (hidden 264,
     128, 64, dropout 0.5, batch 16) for 20 epochs: seconds, steps/s, and a
     test MSE under half the dummy baseline's; then the same initial
     regressor without dropout for 3 epochs on the card and on the CPU in
     the same permutations: parameters within 1e-5,
 17. the predict CLI, each wire (float16, float32, int8) in a process of its
     own (no pandas or JAX imported, matplotlib optional), at N = 131,072
     rows of a float16 store of ViT-L-14-336 (4 crops of 768; two of
     predict's 65,536-row chunks), with phase 16's checkpoint: every row in
     the CSV, the .json writeback, the seeded preview copies, the scores
     within 1e-5 of the same wire computed on the CPU; rows/s split into
     store gather, forward and side effects,
 18. the single-image scorer: the predict_simple CLI on four of phase 15's
     PNGs with phase 16's checkpoint, its ViT-L-14-336 encoder in bfloat16
     (K1 exactly 24 times an image, no other kernel), scores in [0, 1] and
     score-named copies; each image's features within 1e-3 in cosine of the
     crops phase 15's embed CLI wrote for the same file,
 19. the subset CLI on phase 17's directory with a score range: the copied
     files exactly the plain version's (rescaled human labels, predictions,
     the aspect and pixel gates on each JPEG header's size),
 20. the prep CLI in copy mode on phase 4's PNGs and two prompt files (no
     PIL imported): every file copied byte for byte under a uuid name, a
     basename group under one uuid, the natural order kept,
 21. the store CLI's rebuild from phase 15's sidecars: its rows equal to the
     embed-written store's, per uuid; ``info`` one line for the model,
 22. the farthest-point diversity order (torch products: no kernel of the
     table) at N = 262,144 and 1,048,576 of width 768, 500 picks, exact and
     sampled, timed in host preparation and device loop with peak memory,
     and replayed in float64 on the card (each pick within 1e-5 of the
     minimum over every row, or over its own draws),
 23. the loop CLI (no pandas or JAX imported) for three laps of 100 keys
     over 8,192 images with the middle sort: 100/200/300 labels, every row
     predicted each lap, each lap's shown uuids the re-sort of the lap
     before, seconds a lap by part; then a label CLI session with the
     diversity sort, its first 100 uuids the farthest-point order,
 24. the embed CLI on the 32 PNGs: EVA02-L-14-336 int8_static at full width
     and 24 layers (K1 with RoPE on its cls row once and K2 three times a
     layer: ln1, the attention sub-LN, ln2), outputs, .calib.npz, steady
     state and profile,
 25. EVA02-L-14 float32 on 4 images (K1's float32 kernel with RoPE), the
     first against the same encoder on the CPU (1 - cosine ≤ 1e-5),
 26. PE-Core-G14-448 int8_static at all 50 layers on 4 images (K4 with RoPE
     once and K2 twice a layer), timed,
 27. four images each in bfloat16 and int8_static at full width and depth:
     ViT-H-14-CLIPA-336 (K4 at d=80; K2), EVA01-g-14 (K1 at d=88; K2),
     coca_ViT-L-14 (K1; K2), EVA02-E-14 at 64 layers (K1 at d=112; post-norm:
     no K2); ViT-H-14-CLIPA and ViT-bigG-14-CLIPA in bfloat16 (K1 at d=80 and
     104), each timed,
 28. the embed CLI with --aspect native on ViT-SO400M-16-SigLIP2-naflex in
     bfloat16 on 8 PNG copies: 5 crops a sidecar (K1 for the square crops),
     two images' native-aspect rows against the CPU (1 - cosine ≤ 1e-3),
 29. dynamic int8 with CTPU_INT8_BLOCK=hybrid on 4 images: SO400M-384 (K1
     quant_out, K6 three times a layer) and PE-Core-L14-336 (K1 with RoPE:
     a RoPE tower's blocks take the generic block), against int8_static,
 30. the embed flags: --exact_stats --profile_dir on 4 PNG copies (the stats
     equal image_stats_reference's, the trace names K1's kernel), and
     --debug_nans in a process of its own on weights with a NaN in block 5
     (a nonzero exit naming block 5),
 31. the native JPEG decoder: whether it built (why not, if not: no
     failure), and where it did, its canvases against the cv2/PIL path,
 32. the embed CLI on the 32 PNGs: RN50x64/openai int8_static at full width
     and depth (448 px, layers 3, 15, 36, 10; int8_static auto-resolves on at
     final width 4096), on random weights whose residual branches are damped
     by chosen scales (every block's bn3 0.2, ConvNeXt's layer scale 0.1; an
     .npz the CLI finds through --model_path, as phases 33-34 use): outputs,
     the .calib.npz's 64 s{s}b{b}_act_amax of (2,), steady state and
     profile, the first batch (8 images) against the same encoder, weights
     and calibration on the CPU (1 - cosine ≤ 2e-3),
 33. the same for convnext_large_d_320 int8_static (the mlp head; auto on
     at 1536): s{s}_act_amax of (3, 2), (3, 2), (27, 2), (3, 2),
 34. four images each at full width and depth, timed (ms a forward of 16
     crops): RN50 float32 against the CPU (1 - cosine ≤ 1e-5); RN50
     int8_static (auto off: bfloat16, the JAX log line) and int8
     (bfloat16, the JAX warning); RN101, RN50x4, RN50x16 bfloat16; RN50x64
     int8_static;
     convnext_base_w int8_static (auto off: bfloat16); convnext_xxlarge_320
     bfloat16 and int8_static. Phases 32-34 launch no kernel of the table:
     every counter reads 0,
 35. (with phase 16, on its store) the train CLI with --debug_nans in a
     process of its own, 3 epochs: the checkpoint equal bit for bit to the
     flag-off run's; on a copy of the store with one feature row of NaN it
     exits nonzero naming an epoch and a step,
 36. (the parallel layer on the one card: a repeated device makes the mesh,
     whose shards run one after another; correctness and launches, not
     scaling) embed_dataset with a mesh of the card listed twice on copies of
     the PNGs with phase 5's .calib.npz: ViT-L-14-336 int8_static, K1 once
     and K2 twice a layer a shard forward, every crop within 1 - cosine 1e-5
     of phase 5's,
 37. tensor parallel on a (1, 2) mesh against the same encoder on one
     device, 4 images: L-336 int8_static (K2 on the replicated stream, K1 at
     8 heads) and SO400M-384 int8_static (K3 at the local width) at full
     depth, bit-equal where every shard takes the single device's route
     (else within 1 - cosine 2e-3, the routes printed); L-336 bf16 within
     1e-3; exact counters; steady ms beside the single device's,
 38. (after phase 14) find_duplicate_pairs_sharded over the card listed 4
     times at N = 262,144, both wires: phase 14's pair set and overflow
     rows, with the seconds of the ring's counts and of the extract,
 39. (after phase 19) predict over the card listed twice at phase 17's
     131,072 rows: the float32 wire through predict_labels(sharded=True),
     its CSV within 1e-6 of phase 17's; the float16 wire through
     predict_sharded within 2e-3 of phase 17's,
 40. two processes on the card over gloo (COORDINATOR_ADDRESS on localhost,
     JAX_NUM_PROCESSES/JAX_PROCESS_ID): the embed CLI with --distributed on
     copies of the PNGs and two byte-identical copies (each process its
     [rank::2] shard, phase 5's .calib.npz), the store CLI's rebuild, the
     dedup CLI with --distributed --mode copy: both processes report the
     one-process run's pairs, the planted ones among them; the crops within
     1 - cosine 1e-5 of one process embedding the same host shards, and
     within 2e-3 of phase 5's (other batches, other canvas buckets); only
     rank 0 copies,
 41. the host tools through their CLIs, each in a process of its own (no
     pandas, scikit-learn, JAX or the JAX package imported): merge_datasets
     on two datasets of 4,096 rows (labelled and unlabelled halves, one uuid
     in both), its CSVs byte for byte as pandas writes them; move_subset_of_files
     over 8,192 stems x 2 extensions at --fraction_f 0.25 --seed 0, the tree
     random.Random(0)'s draw; fix_img_dir on phase 4's PNGs and planted
     files (a zero-byte file, junk, a broken CRC and a JPEG cut after its SOF
     quarantined; a PNG named .jpg and a JPEG cut in its scan data kept), by
     PIL where installed and by the port's own check in process;
     investigate_embedding on a phase-5 sidecar,
 42. find_similar_imgs (cosine, l2) and svm_similarity through their CLIs on
     phase 17's float16 ViT-L-14-336 store of 131,072 rows x 4 crops x 768
     (kept for this phase) with 30 planted rows near a 40-row context: the
     top 30 the planted rows for each; every distance within 1e-6 of float64 on the card; the SVM's
     gradient norm within 1e-8 of its first, its margins on 16,384 rows
     within 1e-6 of the CPU's; seconds by collection, device and copies,
 43. train_latent_regressor in its default configuration on the card: 1,024
     prompts of [2, 77, 768] latents, a quarter with only a predicted_label;
     a test MSE under half the dummy baseline's, the checkpoint loading with
     the port's regressor; seconds and steps/s,
 44. dryrun_multichip(4) (the 2-D branch) and dryrun_multichip(2) on the
     card listed n times, every check passing, exact launches (K1, and K2 in
     EVA-Test-Wide's lnk blocks); entry()'s flagship step at full width (K1
     24 times), finite unit embeddings,
then print one JSON line with phase 14's records, one with phases 16-19's
and 35's, one with phases 20-23's, one with phase 31's, one with phases
32-34's, one with phases 36-40's, one with phases 41-43's, one with phase
44's, one JSON line listing the kernels, each row with its launches
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
import struct
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
EVICT_SLACK = 2  # eviction records a device_ms trace may lose at its window's start
_evict_kernels: dict = {}  # the eviction's kernels (name → count a call), once seen


def device_ms(fn, reps: int = 20, tries: int = 5) -> float:
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
    on the host before and after its work. Records still go missing there
    late in a long process (the sum alone with no kernel three times in a
    row, or 19 sums of 20, on the H100), so the sum's kernels are named
    once, from the first trace of the sum alone that holds any. A trace is
    used only when the call's own kernels are whole: each appears a
    multiple of ``reps`` times (a lost record of one breaks that), and each
    eviction kernel at most once a call and at least ``EVICT_SLACK`` fewer
    times (a lost eviction record holds none of the call's time). An
    inconsistent trace is printed to stderr and taken again, at most
    ``tries`` times."""
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
        if not _evict_kernels:
            _evict_kernels.update({k: e.count for k, e in counts(evict).items()})
        skip = _evict_kernels
        got = counts(timed)
        seen = {k: e.count for k, e in got.items()}
        own = {k: c for k, c in seen.items() if k not in skip}
        if (skip and own and all(reps * c - EVICT_SLACK <= seen.get(k, 0) <= reps * c
                                 for k, c in skip.items())
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
                  tgen: torch.Generator, ugen: torch.Generator,
                  vgen: torch.Generator) -> list[dict]:
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
    ``rgen``, then ``sgen``, K6's newer rows from ``tgen``, K2's SO400M-384
    row from ``ugen``, and the latest (K1 at the single-image scorer's one
    image of 4 crops) from ``vgen``. K2's rows also carry ``device_ms``."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        flash_attention_packed,
        flash_attention_packed_plain,
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
            (64, 257, f32tc, None, gen), (4 * BATCH, 576, bf16, None, rgen),
            (4, 577, bf16, ("scorer", "K1"), vgen)):
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
    # PE-Core-L14-336 int8_static's rows and the CLI's 64-crop forwards' (one
    # warp a row), then (from ugen) SO400M-384's under CTPU_INT8_WIRE=0 (two)
    k2_ln = {}
    for m, k, path, rg in ((4 * BATCH * 577, 1024, ("pe", "K2"), gen),
                           (64 * 577, 1024, None, gen),
                           (4 * BATCH * 729, 1152, ("so400m_wire0", "K2"), ugen)):
        if k not in k2_ln or rg is not gen:
            k2_ln[k] = (1 + 0.1 * torch.randn((k,), generator=rg, device="cuda"),
                        0.1 * torch.randn((k,), generator=rg, device="cuda"))
        rows.append(rowquant_static_case(m, k, *k2_ln[k], amax, path, rg))

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
        rows.append(q8s_case(b, s, w, heads, path, rg))
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


def q8s_case(b: int, s: int, w: int, heads: int, path, rg: torch.Generator) -> dict:
    """One phase-3 row of K3 at int8 [b, s, 3w] with ``heads`` heads (qkv,
    then the channel scales, from ``rg``) against its plain version: ±1 on
    ≤ 0.1% of entries, timed beside dequantize + SDPA + requantize."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        fused_attention_packed_q8s,
        fused_attention_packed_q8s_plain,
    )

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
    print(f"K3 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
          f"of entries, kernel {row['ms']:.3f} ms plain {row['plain_ms']:.3f} "
          f"dequant+sdpa+quant {row['library_ms']:.3f} bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    if row["flip_share"] > 1e-3:
        fail(f"packed_attention_q8s {row['case']}: ±1 flips on {row['flip_share']:.2e} of "
             "entries (> 1e-3)")
    del qkv, diff
    torch.cuda.empty_cache()
    return row


def rowquant_static_case(m: int, k: int, g: torch.Tensor, bta: torch.Tensor,
                         amax: torch.Tensor, path, rg: torch.Generator) -> dict:
    """One phase-3 row of K2 at bf16 [m, k] (x from ``rg``; the layernorm's
    affine ``g``, ``bta``; the static ``amax``) against its plain version,
    ±1 on ≤ 0.1% of entries, timed (also device time) beside layer_norm + a
    torch quantize."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        rowquant_static,
        rowquant_static_plain,
    )

    inv = torch.tensor(127.0) / amax
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
    print(f"K2 {row['case']}: max |diff| {row['max_abs_err']} on {row['flip_share']:.2e} "
          f"of entries, kernel {row['ms']:.3f} ms (device {row['device_ms']:.4f}) plain "
          f"{row['plain_ms']:.3f} ln+quant {row['library_ms']:.3f} bound "
          f"{row['bound_ms']:.4f} ms", flush=True)
    if row["flip_share"] > 1e-3:
        fail(f"rowquant_static {row['case']}: ±1 flips on {row['flip_share']:.2e} of "
             "entries (> 1e-3)")
    del x, diff
    return row


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
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

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
    return [attention_case(*case) for case in cases]


def attention_case(kname: str, cfg, b: int, spec, with_rope: bool, path,
                   rg: torch.Generator) -> dict:
    """One phase-3 row of K1 or K4 (``kname``) at the tower ``cfg``'s shape
    [b, S, 3w]: the kernel against its plain version, timed beside SDPA on q
    and k already rotated and, with RoPE (the tower's own tables), the torch
    rotation + SDPA (``library_rot_ms``). ``spec``: (type, tolerance, peak
    rate, FMA rate beside a 3xTF32 bound)."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.models.vit import _rope_on
    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        _rot_half,
        fused_attention_packed,
        fused_attention_packed_grouped,
        fused_attention_packed_grouped_plain,
        fused_attention_packed_plain,
    )

    dtype, tol, peak, fma = spec
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
    print(f"{kname} {row['case']}: err {err:.3g} (tol {tol}) kernel {row['ms']:.3f} ms "
          f"plain {row['plain_ms']:.3f} sdpa(rotated q,k) {row['library_ms']:.3f} "
          + (f"rotation+sdpa {rot['library_rot_ms']:.3f} " if rot else "")
          + f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del qkv, q, k, v, q0, k0
    torch.cuda.empty_cache()
    return row



def row_quant_torch(y: torch.Tensor):
    """The library yardstick's dynamic per-row quantize, in torch ops."""
    amax = y.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    return (y * (127.0 / amax)).round_().clamp_(-127, 127).to(torch.int8), amax / 127.0


def rowquant_case(rows_m: int, k: int, with_ln: bool, act, dtype, path,
                  rg: torch.Generator) -> dict:
    """One phase-3 row of K6 at [rows_m, k] of ``dtype`` (inputs from ``rg``):
    with a layernorm, an activation or neither, against its plain version,
    the ±1 share and the scales checked, timed (also device time) beside a
    torch chain (layer_norm or the activation, then a row quantize)."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import rowquant, rowquant_plain

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
    return row


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
    from clip_assisted_data_labeling_tpu_torch.ops.quant import quantize_weight
    from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
        q_linear_fused,
        q_linear_fused_plain,
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
        rows.append(rowquant_case(rows_m, k, with_ln, act, dtype, path, rg))

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

    rows.append(quant_out_case(4 * BATCH, 577, 16, 1024, ("dyn", "K1"), gen))
    return rows


def quant_out_case(b: int, s: int, heads: int, w: int, path, rg: torch.Generator) -> dict:
    """One phase-3 row of K1 with quant_out at bf16 [b, s, 3w] (inputs from
    ``rg``) against its plain version: the int8 values within ±1 on ≤ 0.1%
    of entries, every token's scale within 2^-8 and within 1e-5 on all but ≤
    5% of tokens; timed beside SDPA + a torch row quantize."""
    import torch.nn.functional as F

    from clip_assisted_data_labeling_tpu_torch.ops.attention import (
        fused_attention_packed,
        fused_attention_packed_plain,
    )

    d = w // heads
    qkv = torch.randn((b, s, 3 * w), generator=rg, device="cuda").to(torch.bfloat16)
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
        "path": path,  # a hybrid main path: every K1 launch has quant_out
        "max_abs_err": diff.max().item(), "tol": 1,
        "flip_share": (diff > 0).float().mean().item(), "scale_rel_err": scale_err,
        "scale_off_share": scale_off,
        "ms": time_ms(lambda: fused_attention_packed(qkv, heads, d ** -0.5, quant_out=True)),
        "plain_ms": time_ms(lambda: fused_attention_packed_plain(qkv, heads, d ** -0.5,
                                                                 quant_out=True), min_reps=3),
        "library_ms": time_ms(q_library),
        **bound(4.0 * b * heads * s * s * d, H100_BF16_FLOPS, b * s * (3 * w * 2 + w + 4)),
    }
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
    return row


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
                   dtype: str, model_path: str | None = None) -> None:
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

    enc = CLIPImageEncoder(model, model_path=model_path, compute_dtype=dtype,
                           calibration_path=calib, device="cuda")
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
    shape = f"S={cfg.seq_len}" if hasattr(cfg, "patch_size") and cfg.patch_size else (
        f"{cfg.image_size} px")
    print(f"profile of one batch of {model} {dtype} ({BATCH} images, 4 crops, {shape}): "
          f"device time {total / 1e3:.2f} ms", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:100]}",
              flush=True)
    del enc, batches
    torch.cuda.empty_cache()


def embed_and_check(root: str, model: str, cfg, per_forward: dict,
                    dtype: str = "int8_static", calib_shapes: dict | None = None,
                    model_path: str | None = None) -> dict:
    """A main path through the user's entry point: the embed CLI on the PNGs
    (``dtype``, batch BATCH), with the launch counters zeroed just before
    and read just after — ``per_forward`` for each batch's forward, none for
    int8_static's calibration forward (its attention is the plain XLA-style
    path); then its outputs (a .calib.npz exactly for int8_static, holding
    exactly ``calib_shapes``: by default a ViT's act_amax and qkv_amax),
    steady state and profile; ``model_path`` is passed to the CLI. Returns
    the launch counts, the sidecar paths and their embeddings [N_IMAGES, 4,
    D]."""
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    n_batches = math.ceil(N_IMAGES / BATCH)
    reset_counts()
    t0 = time.perf_counter()
    stores = embed_main(["--root_dir", root, "--models_to_use", model,
                         "--compute_dtype", dtype, "--batch_size", str(BATCH),
                         "--num_workers", "4", "--device", "cuda"]
                        + (["--model_path", model_path] if model_path else []))
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
        want_shapes = calib_shapes or {"act_amax": (cfg.layers, 4),
                                       "qkv_amax": (cfg.layers, 3 * cfg.width)}
        with np.load(calib) as f:
            shapes = {k: f[k].shape for k in f.files if k != "_model_name"}
            named = str(f["_model_name"]) if "_model_name" in f.files else None
        if shapes != want_shapes or named != model:
            fail(f"{model}: calibration shapes {shapes} (model {named})")
        if calib_shapes:
            shapes = f"{len(shapes)} sites"
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
    profile_steady(model, root, calib, cfg, per_forward, dtype, model_path)
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


# --- phases 24-31: the rest of stage 1 on the ViT trunk --------------------------

EVA_L336 = "EVA02-L-14-336/merged2b_s6b_b61k"  # RoPE with a cls row, swiglu 2730, sub-LNs
EVA_L = "EVA02-L-14/merged2b_s4b_b131k"  # 224 px, S=257: its float32 block takes K1
EVA01_G = "EVA01-g-14/laion400m_s11b_b41k"  # d=88 (K1's DP=96 template)
EVA02_E = "EVA02-E-14/laion2b_s4b_b115k"  # 4.4 B parameters, post-norm, d=112
CLIPA_H336 = "ViT-H-14-CLIPA-336/datacomp1b"  # d=80; S=577 at width 1280 takes K4
CLIPA_H = "ViT-H-14-CLIPA/datacomp1b"  # d=80 at S=257: K1
CLIPA_BIGG = "ViT-bigG-14-CLIPA/datacomp1b"  # d=104 (K1's DP=112 template)
COCA_L = "coca_ViT-L-14/laion2b_s13b_b90k"
NAFLEX = "ViT-SO400M-16-SigLIP2-naflex"  # S=256 square crops; native aspect on torch products
FLAG_MODEL = "ViT-B-32/openai"  # the flag runs' small tower (12 layers, S=50)


def check_tower_kernels(wgen: torch.Generator) -> list[dict]:
    """Phase 3, this slice's shapes (inputs from ``wgen``): K1 bf16 at the
    head dims no earlier path ran — d=80 (ViT-H-14-CLIPA), d=88 (EVA01-g-14,
    DP=96), d=104 (ViT-bigG-14-CLIPA, DP=112), d=112 (EVA02-E-14), each at 4
    images x 4 crops of S=257 —, K1 with RoPE on a cls row at EVA02-L-14-336
    int8_static's [32, 577, 3072], K4 bf16 at d=80 (ViT-H-14-CLIPA-336, 4 x
    4) and with RoPE at PE-Core-G14-448 int8_static's [16, 1024, 4608]; K2
    at the int8_static towers' rows (EVA02-L-14-336's ln1/ln2 and attention
    sub-LN [18464, 1024], ViT-H-14-CLIPA-336's [9232, 1280], EVA01-g-14's
    [4112, 1408], PE-Core-G14-448's [16384, 1536]); dynamic int8 hybrid at
    SO400M-384 on 4 images: K6 ln [11664, 1152] and gelu_tanh [11664, 4304],
    K1 quant_out [16, 729, 3456] (d=72)."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    bf16 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)
    rows = [attention_case(k, resolve_config(name), b, bf16, rope, path, wgen)
            for k, name, b, rope, path in (
                ("K1", CLIPA_H, 16, False, ("clipa_h", "K1")),
                ("K1", EVA01_G, 16, False, ("eva01g_bf16", "K1")),
                ("K1", CLIPA_BIGG, 16, False, ("bigg_clipa", "K1")),
                ("K1", EVA02_E, 16, False, ("eva02e_bf16", "K1")),
                ("K1", EVA_L336, 4 * BATCH, True, ("eva02l336", "K1")),
                ("K4", CLIPA_H336, 16, False, ("clipa_h336_bf16", "K4")),
                ("K4", PE_G, 16, True, ("g14_static", "K4")))]
    amax = torch.tensor([6.0], device="cuda")
    for m, k, path in ((4 * BATCH * 577, 1024, ("eva02l336", "K2")),
                       (16 * 577, 1280, ("clipa_h336_static", "K2")),
                       (16 * 257, 1408, ("eva01g_static", "K2")),
                       (16 * 1024, 1536, ("g14_static", "K2"))):
        g = 1 + 0.1 * torch.randn((k,), generator=wgen, device="cuda")
        bta = 0.1 * torch.randn((k,), generator=wgen, device="cuda")
        rows.append(rowquant_static_case(m, k, g, bta, amax, path, wgen))
    so_m = 16 * 729
    rows.append(rowquant_case(so_m, 1152, True, None, torch.bfloat16, ("so400m_hybrid", "K6"),
                              wgen))
    rows.append(rowquant_case(so_m, 4304, False, "gelu_tanh", torch.bfloat16,
                              ("so400m_hybrid", "K6"), wgen))
    rows.append(quant_out_case(16, 729, 16, 1152, ("so400m_hybrid", "K1"), wgen))
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


def towers(root: str, l336: dict) -> dict:
    """Phases 24-27: the EVA, CLIPA and CoCa towers and PE's G14 in
    int8_static. Returns each path's launch counts by the name the phase-3
    rows use.
      24. the embed CLI on the 32 PNGs: EVA02-L-14-336 int8_static at full
          width and 24 layers (K1 with RoPE on its cls row once and K2 three
          times a layer: ln1, the attention sub-LN with a[1], ln2), with
          calibration and .calib.npz, steady state and profile,
      25. EVA02-L-14 float32 on one image (K1's float32 kernel with RoPE in
          every layer), within 1e-5 cosine of the same encoder on the CPU,
      26. PE-Core-G14-448 int8_static at all 50 layers on 4 images (K4 with
          RoPE once and K2 twice a layer),
      27. on 4 images each, bf16 then int8_static (calibrated on the same
          batch): ViT-H-14-CLIPA-336 (K4 at d=80; K2), EVA01-g-14 (K1 at
          d=88; K2), coca_ViT-L-14 (K1; K2) and EVA02-E-14 at all 64
          layers (K1 at d=112; its post-norm blocks take the generic block
          in int8_static, so no K2); bf16 only: ViT-H-14-CLIPA (K1 at d=80
          on S=257) and ViT-bigG-14-CLIPA (K1 at d=104)."""
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    out = {}
    ecfg = resolve_config(EVA_L336)
    eva = embed_and_check(root, EVA_L336, ecfg, {"K1": ecfg.layers, "K2": 3 * ecfg.layers})
    out["eva02l336"] = eva["launches"]
    lcfg = resolve_config(EVA_L)
    out["eva02l_f32"] = encoder_run(EVA_L, "float32", l336["pts"], None, lcfg,
                                    {"K1": lcfg.layers}, timed=True, cpu_ref=True,
                                    cpu_images=1)
    gcfg = resolve_config(PE_G)
    out["g14_static"] = encoder_run(PE_G, "int8_static", l336["pts"], None, gcfg,
                                    {"K4": gcfg.layers, "K2": 2 * gcfg.layers}, timed=True)
    for key, name, kernel, static_k2 in (("clipa_h336", CLIPA_H336, "K4", True),
                                         ("eva01g", EVA01_G, "K1", True),
                                         ("coca", COCA_L, "K1", True),
                                         ("eva02e", EVA02_E, "K1", False)):
        cfg = resolve_config(name)
        bf = encoder_run(name, "bfloat16", l336["pts"], None, cfg, {kernel: cfg.layers},
                         timed=True)
        want = {kernel: cfg.layers, **({"K2": 2 * cfg.layers} if static_k2 else {})}
        st = encoder_run(name, "int8_static", l336["pts"], None, cfg, want, timed=True)
        out[f"{key}_bf16"], out[f"{key}_static"] = bf, st
    for key, name in (("clipa_h", CLIPA_H), ("bigg_clipa", CLIPA_BIGG)):
        cfg = resolve_config(name)
        out[key] = encoder_run(name, "bfloat16", l336["pts"], None, cfg, {"K1": cfg.layers},
                               timed=True)
    return out


def naflex_native(root: str) -> dict:
    """Phase 28: the embed CLI with ``--aspect native`` on ViT-SO400M-16-
    SigLIP2-naflex in bfloat16, on copies of 8 of the PNGs in a fresh
    directory (one batch): the square crops through K1 (27 launches, S=256),
    the native-aspect rows through the masked torch path (no kernel); each
    sidecar holds 5 crops; the first two images' native-aspect rows within
    the bf16 limit (1 − cosine ≤ 1e-3) of the same encoder on the CPU (the
    weights made on the card as the CLI makes them, moved across). Returns
    the launch counts."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import params_from_module
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.models.naflex import target_grid
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    cfg = resolve_config(NAFLEX)
    pngs = sorted(glob.glob(os.path.join(root, "*.png")))[:BATCH]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_naflex_") as nroot:
        for p in pngs:
            shutil.copy(p, nroot)
        reset_counts()
        t0 = time.perf_counter()
        embed_main(["--root_dir", nroot, "--models_to_use", NAFLEX, "--compute_dtype",
                    "bfloat16", "--aspect", "native", "--batch_size", str(BATCH),
                    "--num_workers", "4", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want = {k: {"K1": cfg.layers}.get(k, 0) for k in got}
        if got != want:
            fail(f"{NAFLEX} --aspect native: launches {got}, expected {want}")
        pts = sorted(glob.glob(os.path.join(nroot, "*.pt")))
        crops = [sorted(read_sidecar(p)[NAFLEX]) for p in pts]
        store = EmbeddingStore.open(nroot, NAFLEX)
        names = store.meta["crop_names"]
        if len(pts) != len(pngs) or names[-1] != "native_aspect" or any(
                len([c for c in cs if not c.startswith("img_stat")]) != 5 for cs in crops):
            fail(f"{NAFLEX} --aspect native: {len(pts)} sidecars, crops {names}")
        emb = np.asarray(store.embeddings, np.float32)
        enc = CLIPImageEncoder(NAFLEX, compute_dtype="bfloat16", device="cuda")
        params = {k: torch.from_numpy(v) for k, v in params_from_module(enc.model).items()}
        del enc
        cpu = CLIPImageEncoder(NAFLEX, params=params, compute_dtype="bfloat16", device="cpu")
        batch = next(iter(BatchedImageLoader(sorted(glob.glob(os.path.join(nroot, "*.png")))[:2],
                                             canvas_size=1024, out_size=cfg.image_size,
                                             batch_size=2, num_workers=2)))
        imgs = []
        for bi in range(batch.n_valid):
            ox, oy, w, h = (int(v) for v in batch.stat_params[bi, :4])
            imgs.append(batch.canvas[bi, oy: oy + h, ox: ox + w])
        t1 = time.perf_counter()
        ref = cpu.encode_variable(imgs).numpy()
        cpu_s = time.perf_counter() - t1
        nat = emb[[store.index_of(os.path.splitext(os.path.basename(p))[0])
                   for p in batch.paths], -1]
        err = float(1.0 - np.sum(nat * ref, axis=-1).min())
        grids = [target_grid(im.shape[0], im.shape[1], cfg.patch_size, cfg.seq_len)
                 for im in imgs]
    print(f"phase 28 {NAFLEX} bf16 --aspect native: {len(pngs)} images x 5 crops in "
          f"{wall:.2f} s (model init included); launches {got}; native-aspect rows of "
          f"{len(imgs)} images (grids {grids}) against the CPU ({cpu_s:.1f} s): 1 - cosine "
          f"max {err:.3g}", flush=True)
    if not err <= 1e-3:
        fail(f"{NAFLEX} native-aspect rows disagree with the CPU (1 - cosine {err})")
    return got


def dynamic_int8_more(so400m: dict, pe: dict, scfg, pcfg) -> dict:
    """Phase 29: dynamic int8 under CTPU_INT8_BLOCK=hybrid on 4 images:
    SO400M-384 (the hybrid block: K1 with quant_out at d=72 once and K6
    three times a layer, gelu_tanh among them) and PE-Core-L14-336 (a RoPE
    tower's dynamic-int8 blocks take the generic block: K1 with RoPE once a
    layer), each against its int8_static embeddings."""
    out = {}
    with int8_knobs(CTPU_INT8_BLOCK="hybrid", CTPU_FUSED_QMATMUL="0"):
        out["so400m_hybrid"] = encoder_run(SIGLIP, "int8", so400m["pts"], so400m["side"], scfg,
                                           {"K1": scfg.layers, "K6": 3 * scfg.layers},
                                           timed=True)
        out["pe_hybrid"] = encoder_run(PE_L, "int8", pe["pts"], pe["side"], pcfg,
                                       {"K1": pcfg.layers}, timed=True)
    return out


def embed_flags(root: str) -> dict:
    """Phase 30: the three embed flags, on copies of 4 of the PNGs in fresh
    directories. ``--exact_stats --profile_dir`` (ViT-L-14-336/openai,
    bfloat16): the store's stats equal ``image_stats_reference`` on each
    file, and the trace file exists and names K1's kernel
    (``exact_wgmma_kernel``); ``--debug_nans`` in a process of its own
    (ViT-B-32/openai, bfloat16, weights with one NaN in block 5's fc2): it
    exits nonzero, naming block 5. Returns the flag run's launch counts."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import decode_rgb
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import save_params_npz
    from clip_assisted_data_labeling_tpu_torch.models.encoders import _stable_seed
    from clip_assisted_data_labeling_tpu_torch.models.vit import init_vit_params, resolve_config
    from clip_assisted_data_labeling_tpu_torch.ops.image_stats import (
        IMG_STAT_KEYS,
        image_stats_reference,
    )
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

    pngs = sorted(glob.glob(os.path.join(root, "*.png")))[:4]
    cfg = resolve_config(MODEL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flags_") as froot:
        data, prof_dir = os.path.join(froot, "data"), os.path.join(froot, "profile")
        os.makedirs(data)
        for p in pngs:
            shutil.copy(p, data)
        reset_counts()
        embed_main(["--root_dir", data, "--models_to_use", MODEL, "--compute_dtype",
                    "bfloat16", "--batch_size", str(BATCH), "--num_workers", "4",
                    "--exact_stats", "--profile_dir", prof_dir, "--device", "cuda"])
        got = counts()
        if got != {k: {"K1": cfg.layers}.get(k, 0) for k in got}:
            fail(f"--exact_stats --profile_dir run: launches {got}")
        store = EmbeddingStore.open(data, MODEL)
        stats = np.asarray(store.img_stats, np.float32)
        order = [os.path.join(data, r) for r in store.rel_paths()]
        want = np.asarray([[image_stats_reference(decode_rgb(p))[k] for k in IMG_STAT_KEYS]
                           for p in order], np.float32)
        stat_err = float(np.abs(stats - want).max())
        trace = os.path.join(prof_dir, "embed_trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as f:
            names_k1 = "exact_wgmma_kernel" in f.read()
        print(f"phase 30 --exact_stats: {len(order)} images, stats against "
              f"image_stats_reference max |diff| {stat_err:.3g}; --profile_dir: {trace} "
              f"{size} bytes, names K1's exact_wgmma_kernel: {names_k1}", flush=True)
        if stat_err > 1e-6 or not names_k1:
            fail("--exact_stats stats differ from the CPU's, or the trace lacks K1")

        bad = os.path.join(froot, "weights")
        os.makedirs(bad)
        bcfg = resolve_config(FLAG_MODEL)
        params = init_vit_params(bcfg, torch.Generator().manual_seed(_stable_seed(FLAG_MODEL)))
        params["blocks/fc2_kernel"][5, 0, 0] = float("nan")
        save_params_npz(os.path.join(bad, FLAG_MODEL.replace("/", "-") + ".npz"), params)
        nan_data = os.path.join(froot, "nan_data")
        os.makedirs(nan_data)
        for p in pngs:
            shutil.copy(p, nan_data)
        proc = subprocess.run(
            [sys.executable, "-m", "clip_assisted_data_labeling_tpu_torch.pipeline.embed",
             "--root_dir", nan_data, "--models_to_use", FLAG_MODEL, "--model_path", bad,
             "--compute_dtype", "bfloat16", "--debug_nans", "--num_workers", "2",
             "--device", "cuda"],
            capture_output=True, text=True, timeout=300, cwd=os.path.dirname(
                os.path.abspath(__file__)))
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        print(f"phase 30 --debug_nans: exit {proc.returncode}; {last}", flush=True)
        if proc.returncode == 0 or "FloatingPointError" not in last or "block 5 " not in last:
            fail(f"--debug_nans did not stop at block 5: exit {proc.returncode}, {last}")
    return got


def native_decoder() -> dict:
    """Phase 31: the native JPEG decoder. Prints whether it built (and why
    not, which is no failure: the loader falls back to cv2/PIL as the JAX
    package's does); where it built and a JPEG encoder (cv2 or PIL) can
    write 6 JPEGs of mixed sizes, its canvases against the cv2/PIL path:
    the batch's mean |Δ| < 1, as tests/test_native_loader.py holds, and so
    each image that fits the 512 canvas (a larger one is decoded at a DCT
    prescale, then area-filtered: another resample chain)."""
    from clip_assisted_data_labeling_tpu_torch.data import loader, native_loader

    t0 = time.perf_counter()
    lib = native_loader.get_lib()
    built_s = time.perf_counter() - t0
    rec = {"built": lib is not None, "build_s": built_s, "error": native_loader.build_error()}
    if lib is None:
        print(f"phase 31 native decoder: not built ({rec['error']}); the loader decodes with "
              f"{loader.decoder_name()}", flush=True)
        return rec
    rng = np.random.default_rng(31)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as jroot:
        paths = []
        for i in range(6):  # three within the 512 canvas, three larger
            h, w = (int(v) for v in rng.integers(120, 500 if i < 3 else 1400, 2))
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.clip(np.stack([xx * 255.0 / w, yy * 255.0 / h, np.full((h, w), 90.0)], -1)
                          + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
            p = os.path.join(jroot, f"img_{i}.jpg")
            if loader.cv2 is not None:
                loader.cv2.imwrite(p, img[:, :, ::-1], [loader.cv2.IMWRITE_JPEG_QUALITY, 95])
            elif loader.Image is not None:
                loader.Image.fromarray(img).save(p, quality=95)
            else:
                print("phase 31 native decoder: built; no JPEG encoder (cv2, PIL) to write "
                      "test files", flush=True)
                return rec
            paths.append(p)
        kw = dict(canvas_size=512, out_size=224, batch_size=6, num_workers=4)
        nat = loader.BatchedImageLoader(paths, **kw)
        ref = loader.BatchedImageLoader(paths, use_native=False, **kw)
        nb, rb = next(iter(nat)), next(iter(ref))
        diff = np.abs(nb.canvas.astype(int) - rb.canvas.astype(int))
        fits = [i for i, p in enumerate(nb.paths)
                if max(loader.decode_rgb(p).shape[:2]) <= kw["canvas_size"]]
    rec.update(decoders=dict(nat.decoders), mean_abs_diff=float(diff.mean()),
               mean_abs_diff_fitting=[float(diff[i].mean()) for i in fits])
    print(f"phase 31 native decoder: built in {built_s:.1f} s; {dict(nat.decoders)} against "
          f"{dict(ref.decoders)}: mean |diff| {rec['mean_abs_diff']:.3f} over the batch, "
          f"{rec['mean_abs_diff_fitting']} on the images that fit the canvas", flush=True)
    if (nat.decoders.get("native") != len(paths) or rec["mean_abs_diff"] >= 1.0
            or any(d >= 1.0 for d in rec["mean_abs_diff_fitting"])):
        fail(f"native decoder canvases differ from the {loader.decoder_name()} path: {rec}")
    return rec


DEDUP_N, DEDUP_D = 262144, 768  # ViT-L-14-336's embedding width
DEDUP_PAIRS, DEDUP_GROUP = 400, 40


# --- phases 32-35: the conv towers in stage 1, train's --debug_nans ----------------

RN50X64 = "RN50x64/openai"  # 448 px, layers (3, 15, 36, 10), final width 4096
CNX_LD320 = "convnext_large_d_320/laion2b_s29b_b131k_ft_soup"  # mlp head, final width 1536
RN50, RN101 = "RN50/openai", "RN101/openai"
RN50X4, RN50X16 = "RN50x4/openai", "RN50x16/openai"
CNX_BW = "convnext_base_w/laion2b_s13b_b82k"  # final width 1024: int8_static auto-resolves off
CNX_XXL320 = "convnext_xxlarge_320/laion2b_s34b_b82k_augreg_soup"


@contextlib.contextmanager
def encoder_log():
    """The encoder module's log records (INFO and up) during the block."""
    import logging

    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger("clip_assisted_data_labeling_tpu_torch.models.encoders")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


# chosen damping scales (not trained values) for the residual branches of the
# random weights of phases 32-34, by key: every bottleneck's folded bn3 scale
# (the encoder's random init, as the JAX package's, leaves it at 1) and every
# ConvNeXt stage's layer scale (initialized at 1e-6, which leaves the blocks out
# of the output); the ResNet stem's bn3 keeps its init
DAMPING = {re.compile(r"s\d+b\d+_bn3_scale"): 0.2, re.compile(r"s\d+_gamma"): 0.1}


def conv_params(model: str) -> dict:
    """The random weights phases 32-34 give a conv tower: the encoder's own
    random init on the card (seeded by the model name), with the residual
    branches damped by DAMPING, as CPU tensors. Undamped (bn3 at 1), the
    random RN50x64's residual stream grows ~80x over its 64 blocks and its
    attention pool's softmax saturates to one token a head: card and CPU
    then part on near-tied argmaxes (bf16 1 - cosine 3.4e-3, int8_static
    1.6e-2, where each block alone agrees within 2e-7), and so do the CPU's
    own bf16 and float32 runs (7e-3)."""
    from clip_assisted_data_labeling_tpu_torch.models.conv_tower import conv_family
    from clip_assisted_data_labeling_tpu_torch.models.encoders import _stable_seed
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    cfg = resolve_config(model)
    gen = torch.Generator(device="cuda").manual_seed(_stable_seed(model))
    params = conv_family(cfg).init(cfg, gen, "cuda")
    for k, v in params.items():
        for pattern, scale in DAMPING.items():
            if pattern.fullmatch(k):
                params[k] = torch.full_like(v, scale)
    return {k: v.cpu() for k, v in params.items()}


def conv_cpu_check(model: str, dtype: str, cfg, pngs: list, emb: np.ndarray, limit: float,
                   params: dict, calib: str | None = None) -> float:
    """The card's embeddings ``emb`` [n, 4, D] of ``pngs`` against the same
    encoder on the CPU: the same weights ``params`` and, for int8_static,
    the same calibration file. 1 - cosine of every crop within ``limit``;
    returns it."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder

    cpu = CLIPImageEncoder(model, params=params, compute_dtype=dtype,
                           calibration_path=calib, device="cpu")
    if calib is not None and not cpu.load_calibration():
        fail(f"{model}: the CPU encoder did not load {calib}")
    batch = next(iter(BatchedImageLoader(pngs, canvas_size=1024, out_size=cfg.image_size,
                                         batch_size=len(pngs), num_workers=2)))
    t0 = time.perf_counter()
    ref = cpu.embed_crops(batch.canvas, batch.crop_params)[: batch.n_valid].numpy()
    cpu_s = time.perf_counter() - t0
    order = [pngs.index(p) for p in batch.paths]
    err = float(1.0 - np.sum(emb[order] * ref, axis=-1).min())
    print(f"{model} {dtype} card vs CPU (same weights{', same .calib.npz' if calib else ''}; "
          f"{ref.shape[0]} x {ref.shape[1]} crops, CPU {cpu_s:.1f} s): 1 - cosine max "
          f"{err:.3g} (limit {limit:g})", flush=True)
    if not err <= limit:
        fail(f"{model} {dtype}: card and CPU embeddings disagree (1 - cosine {err})")
    return err


def conv_cli(root: str, model: str, cfg, calib_shapes: dict, cpu_images: int = BATCH) -> dict:
    """Phases 32-33: a conv tower in int8_static through the embed CLI on the
    32 PNGs at full width and depth, its weights (:func:`conv_params`) found
    by the CLI as ``<model>.npz`` in a ``--model_path`` directory (no kernel
    of the table: every launch counter 0), its outputs and .calib.npz
    (exactly ``calib_shapes``), steady state and profile, then the first
    ``cpu_images`` images of the store (the first batch) against the same
    encoder, weights and calibration on the CPU (1 - cosine ≤ 2e-3). Returns its record and
    launch counts."""
    from clip_assisted_data_labeling_tpu_torch.models.clip_weights import save_params_npz

    params = conv_params(model)
    weights = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        save_params_npz(os.path.join(weights, model.replace("/", "-") + ".npz"), params)
        res = embed_and_check(root, model, cfg, {}, calib_shapes=calib_shapes,
                              model_path=weights)
    finally:
        shutil.rmtree(weights, ignore_errors=True)
    calib = os.path.join(root, model.replace("/", "-") + ".calib.npz")
    pngs = [p[:-3] + ".png" for p in res["pts"][:cpu_images]]
    err = conv_cpu_check(model, "int8_static", cfg, pngs, res["side"][:cpu_images], 2e-3,
                         params, calib)
    return {"record": {"model": model, "dtype": "int8_static", "cpu_cos_err": err},
            "launches": res["launches"], "pts": res["pts"]}


def conv_tower(model: str, dtype: str, pts: list, cfg, runs_as: str | None = None,
               note: str | None = None, cpu_limit: float | None = None) -> dict:
    """Phase 34: four images through the encoder in ``dtype`` at full width
    and depth on the weights of :func:`conv_params`, on the card: finite
    unit embeddings, no launch of a kernel of
    the table, the downgrade the JAX package makes (``runs_as``, the log
    line containing ``note``), the steady ms of a forward of the 16 crops
    (CUDA events), and with ``cpu_limit`` all four images against the same
    encoder on the CPU. Returns the record and the launch counts."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder

    params = conv_params(model)
    with encoder_log() as records:
        enc = CLIPImageEncoder(model, params=params, compute_dtype=dtype, device="cuda")
    runs = ("int8_static" if enc.static_quant else "int8" if enc.quantized
            else str(enc.compute_dtype).replace("torch.", ""))
    lines = [r.getMessage() for r in records if "running bfloat16" in r.getMessage()]
    if runs != (runs_as or dtype) or (note and not any(note in m for m in lines)):
        fail(f"{model} {dtype}: runs {runs}, log {lines}")
    pngs = [p[:-3] + ".png" for p in pts[:4]]
    batch = next(iter(BatchedImageLoader(pngs, canvas_size=1024, out_size=cfg.image_size,
                                         batch_size=4, num_workers=4)))
    reset_counts()
    emb = enc.embed_crops(batch.canvas, batch.crop_params)[: batch.n_valid].cpu().numpy()
    got = counts()
    norms = np.linalg.norm(emb, axis=-1)
    if any(got.values()) or not (np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3):
        fail(f"{model} {dtype}: launches {got}, norms {norms.min()}..{norms.max()}")
    canvas = torch.from_numpy(batch.canvas).to("cuda")
    ms = time_ms(lambda: enc.embed_crops(canvas, batch.crop_params), min_reps=3, min_s=0.5)
    order = [pngs.index(p) for p in batch.paths]
    emb = emb[np.argsort(order)]  # in the order of pts
    rec = {"model": model, "dtype": dtype, "runs": runs, "ms_per_forward_16_crops": ms}
    print(f"phase 34 {model} {dtype} (runs {runs}{'; ' + lines[0] if lines else ''}): "
          f"{ms:.3f} ms per forward of {emb.shape[0]} images x 4 crops ({cfg.image_size} px); "
          f"launches {got}", flush=True)
    del enc, canvas
    torch.cuda.empty_cache()
    if cpu_limit is not None:
        rec["cpu_cos_err"] = conv_cpu_check(model, dtype, cfg, pngs, emb, cpu_limit, params)
    return {"record": rec, "launches": got}


def conv_towers(root: str) -> tuple[list[dict], dict]:
    """Phases 32-34: the modified ResNets and ConvNeXt in stage 1, on random
    weights with damped residual branches (:func:`conv_params`).
    Returns the records and each path's launch counts (all 0: the conv towers run
    cuDNN convolutions and torch products, as the JAX package runs XLA's,
    and int8_static's 1x1 products through ``torch._int_mm``).
      32. the embed CLI, RN50x64 int8_static (auto on: final width 4096) at
          448 px and all 64 blocks: 64 s{s}b{b}_act_amax of (2,), steady
          state, profile, the first batch against the CPU,
      33. the same for convnext_large_d_320 int8_static (the mlp head, auto
          on at 1536): s{s}_act_amax of (3, 2), (3, 2), (27, 2), (3, 2),
      34. four images each: RN50 float32 against the CPU (1 - cosine ≤
          1e-5); RN50 int8_static (auto off: bfloat16, the JAX log line) and
          int8 (bfloat16, the JAX warning); RN101, RN50x4, RN50x16 bf16;
          RN50x64 int8_static; convnext_base_w int8_static (auto off: bfloat16);
          convnext_xxlarge_320 bf16 and int8_static; each timed."""
    from clip_assisted_data_labeling_tpu_torch.models.resnet import _block_widths
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    records, paths = [], {}
    rcfg = resolve_config(RN50X64)
    rn = conv_cli(root, RN50X64, rcfg, {f"s{s}b{b}_act_amax": (2,)
                                       for s, b, *_ in _block_widths(rcfg)})
    ccfg = resolve_config(CNX_LD320)
    cnx = conv_cli(root, CNX_LD320, ccfg, {f"s{s}_act_amax": (d, 2)
                                          for s, d in enumerate(ccfg.depths)})
    records += [rn["record"], cnx["record"]]
    paths["rn50x64_static"], paths["cnx_ld320_static"] = rn["launches"], cnx["launches"]
    pts = rn["pts"]
    for key, model, dtype, kw in (
            ("rn50_f32", RN50, "float32", dict(cpu_limit=1e-5)),
            ("rn50_static", RN50, "int8_static",
             dict(runs_as="bfloat16", note="int8_static auto-resolves OFF")),
            ("rn50_int8", RN50, "int8",
             dict(runs_as="bfloat16", note="no dynamic-int8 formulation")),
            ("rn101", RN101, "bfloat16", {}),
            ("rn50x4", RN50X4, "bfloat16", {}),
            ("rn50x16", RN50X16, "bfloat16", {}),
            ("rn50x64_static_fwd", RN50X64, "int8_static", {}),
            ("cnx_bw_static", CNX_BW, "int8_static",
             dict(runs_as="bfloat16", note="int8_static auto-resolves OFF")),
            ("cnx_xxl320_bf16", CNX_XXL320, "bfloat16", {}),
            ("cnx_xxl320_static", CNX_XXL320, "int8_static", {})):
        out = conv_tower(model, dtype, pts, resolve_config(model), **kw)
        records.append(out["record"])
        paths[key] = out["launches"]
    return records, paths


def train_debug_nans(base: str) -> dict:
    """Phase 35: the train CLI with --debug_nans, each run in a process of
    its own (3 epochs of phase 16's configuration): on phase 16's store the
    checkpoint equals the flag-off run's bit for bit; on a copy of the store
    with one feature row set to NaN it exits nonzero, naming an epoch and a
    step."""
    from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
    from clip_assisted_data_labeling_tpu_torch.pipeline import train as ttrain
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

    data = os.path.join(base, "data")
    argv = ["--train_data_dir", data, "--train_data_names", "labelled", "--n_epochs", "3",
            "--device", "cuda"]
    ckpts, walls = {}, {}
    for flag in ("off", "on"):
        cwd = os.path.join(base, f"debug_nans_{flag}")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        run_cli("clip_assisted_data_labeling_tpu_torch.pipeline.train",
                argv + (["--debug_nans"] if flag == "on" else []),
                f"phase 35 train --debug_nans {flag}", cwd=cwd)
        walls[flag] = time.perf_counter() - t0
        found = glob.glob(os.path.join(cwd, "models", "*.npz"))
        if len(found) != 1:
            fail(f"phase 35: train --debug_nans {flag} wrote {found}")
        with np.load(found[0]) as f:
            ckpts[flag] = {k: f[k] for k in f.files}
    same = (set(ckpts["on"]) == set(ckpts["off"])
            and all(np.array_equal(ckpts["on"][k], ckpts["off"][k]) for k in ckpts["off"]))
    nan_data = os.path.join(base, "data_nan")
    shutil.copytree(data, nan_data)  # the store and its label CSV beside it
    # one row, and one that the CLI's split puts in the training rows
    cfg = TrainConfig()
    store = EmbeddingStore.open(os.path.join(nan_data, "labelled"), MODEL, mode="r+")
    for row in range(len(store.embeddings)):
        keep = np.array(store.embeddings[row])
        store.embeddings[row] = np.nan
        store.flush()
        np.random.seed(cfg.random_seed)
        x, _y, _models = ttrain.load_training_data(
            nan_data, ["labelled"], list(cfg.clip_models_to_use), list(cfg.crop_names),
            cfg.use_img_stat_features)
        if np.isin(np.flatnonzero(np.isnan(x).any(axis=1)), ttrain._split(len(x), cfg)[1]).any():
            break
        store.embeddings[row] = keep
    store.flush()
    del store, x
    cwd = os.path.join(base, "debug_nans_nan")
    os.makedirs(cwd)
    proc = subprocess.run([sys.executable, "-m", "clip_assisted_data_labeling_tpu_torch.pipeline"
                           ".train", "--train_data_dir", nan_data, *argv[2:], "--debug_nans"],
                          capture_output=True, text=True, timeout=600, cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(
                              os.path.abspath(__file__))))
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    named = re.search(r"FloatingPointError: .* at epoch (\d+), step (\d+)", last)
    rec = {"stage": "train --debug_nans", "checkpoint_bit_equal": same, "nan_row": row,
           "off_s": walls["off"], "on_s": walls["on"], "nan_exit": proc.returncode,
           "nan_error": last}
    print(f"phase 35 train CLI --debug_nans: 3 epochs off {walls['off']:.1f} s, on "
          f"{walls['on']:.1f} s, checkpoints bit-equal {same}; with NaN in row {row}: exit "
          f"{proc.returncode}, {last}", flush=True)
    if not same or proc.returncode == 0 or named is None:
        fail(f"train --debug_nans: bit-equal {same}, NaN run exit {proc.returncode}: {last}")
    return rec


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


def dedup_at_scale() -> tuple[list[dict], dict]:
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
    found and the wires' overflow rows agree. Returns one record a run, and
    for phase 38 the embeddings, the pair set and the overflow rows."""
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

    phase14 = {"emb": emb, "pairs": plain, "overflow_rows": results["int8"].overflow_rows}
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
    return records, phase14


def dedup_cli(root: str, base: str) -> dict:
    """Phase 15: the dedup CLI end to end on the card. Six of the PNGs and
    byte-identical copies of two of them in ``base``/mydata, embedded by
    the embed CLI (ViT-L-14-336/openai, bfloat16; counters zeroed before and
    read after), then ``python -m ...pipeline.dedup --threshold 0.99 --mode
    copy`` in a process of its own (``-X importtime``: neither pandas nor
    matplotlib may be imported). Fails unless the planted pairs are found,
    the pairs its copies name equal the plain route's on the same store
    (random-weight towers make a narrow cone, so other pairs may pass too),
    and every pair's file groups are in near_duplicates_cosine_0.99. Returns
    the embed's launch counts and, for phase 18, the crops of img_000 to
    img_003 in the store the embed wrote (name → [4, D] float32); phase 21
    rebuilds that store from the embed's sidecars."""
    from clip_assisted_data_labeling_tpu_torch.config import DedupConfig
    from clip_assisted_data_labeling_tpu_torch.pipeline.dedup import load_embeddings
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import main as embed_main
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

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
    store = EmbeddingStore.open(droot, MODEL)
    rows = {f"img_{i:03d}.png": np.asarray(store.embeddings[store.index_of(f"img_{i:03d}")],
                                           np.float32) for i in range(4)}
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
    return embed_counts, rows


STAGE_D = 768  # ViT-L-14-336's embedding width: 2 crops make the regressor's 1536 inputs
TRAIN_N = 9400  # the labels of the reference's shipped single_crop_regression_9.4k_imgs
# a third of the default 60 (two of its 10-epoch rate cycles): the eager steps
# took 82-91 s at 60, the largest share of the script's time limit one phase held
TRAIN_EPOCHS = 20
PREDICT_N = 131072  # two of predict's ASSEMBLE_CHUNKs of 65536 rows
PREDICT_WIRES = ("float16", "float32", "int8")
N_LABELLED = 2048  # rows of the predict set with a human label (subset rescales them)
# the latent's share of a crop's variance: with the signal along one direction
# of 1/768 of it, the default run's weight decay outweighs the data's gradient
# and the regressor learns only the mean (a first card run: test MSE 0.0506
# against the dummy baseline's 0.0506); at 8% it learns
LATENT_SHARE = 0.08
SUBSET_RANGE, SUBSET_MIN_PIXELS = (0.54, 0.56), 64 * 64  # label 5 (5/9) falls inside


def write_feature_store(root: str, n: int, seed: int) -> tuple[list[str], np.ndarray]:
    """A float16 columnar store of MODEL as the embed stage writes it: n rows
    of 4 unit-norm crops of STAGE_D and 22 stats, drawn on the card from
    ``seed``. Each row has a latent z ~ N(0, 1) that moves each crop along a
    unit direction of its own (LATENT_SHARE of the crop's variance before
    the norm), the signal a label can carry. Returns the uuids (32 hex
    digits) and z."""
    from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

    uuids = [f"{seed:04x}{i:028x}" for i in range(n)]
    store = EmbeddingStore.create(root, MODEL, list(ALL_CROPS), STAGE_D, uuids,
                                  dtype="float16", with_stats=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    directions = torch.randn((len(ALL_CROPS), STAGE_D), generator=gen, device="cuda")
    directions = directions / directions.norm(dim=-1, keepdim=True)
    latent = torch.randn((n,), generator=gen, device="cuda")
    alpha = math.sqrt(LATENT_SHARE / (1 - LATENT_SHARE))
    for s in range(0, n, 16384):
        k = min(16384, n - s)
        emb = (torch.randn((k, len(ALL_CROPS), STAGE_D), generator=gen, device="cuda")
               / math.sqrt(STAGE_D) + alpha * latent[s:s + k, None, None] * directions)
        emb = emb / emb.norm(dim=-1, keepdim=True)
        stats = torch.randn((k, 22), generator=gen, device="cuda")
        store.write_rows(s, emb.half().cpu().numpy(), stats.cpu().numpy())
    store.flush()
    return uuids, latent.cpu().numpy()


def write_labels(root: str, uuids: list[str], labels: np.ndarray) -> None:
    """The label CSV of ``root``: ``labels`` on the first rows, the rest
    without a row (predict adds them)."""
    from clip_assisted_data_labeling_tpu_torch.store.database import (
        LabelDatabase,
        database_path_for,
    )

    n = len(labels)
    LabelDatabase({"uuid": uuids[:n], "label": labels, "timestamp": np.full(n, 1.7e9),
                   "predicted_label": np.full(n, np.nan)}, database_path_for(root)).save()


def train_on_card(base: str) -> dict:
    """Phase 16: stage 4 at the reference's label-set size. TRAIN_N rows of
    ViT-L-14-336's width in a float16 store, labelled 0-9 as the labelling
    UI writes them: the rows' latent (2 label steps a standard deviation)
    plus noise (0.5), rounded. The train CLI in the default configuration (hidden 264, 128,
    64, dropout 0.5, batch 16) for TRAIN_EPOCHS epochs on the card: seconds, steps/s and
    the final test MSE, which must be under half the dummy baseline's. Then
    the same initial regressor without dropout for 3 epochs on the card and
    on the CPU, in the same permutations (drawn on the CPU): parameters
    within 1e-5. Returns the record and the checkpoint's path."""
    from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
    from clip_assisted_data_labeling_tpu_torch.models.regressor import SimpleFCRegressor
    from clip_assisted_data_labeling_tpu_torch.pipeline import train as ttrain

    t_phase = time.perf_counter()
    data = os.path.join(base, "data")
    root = os.path.join(data, "labelled")
    os.makedirs(root)
    uuids, z = write_feature_store(root, TRAIN_N, 16)
    rng = np.random.default_rng(16)
    labels = np.clip(np.round(4.5 + 2.0 * z + rng.normal(0, 0.5, TRAIN_N)), 0, 9)
    write_labels(root, uuids, labels)

    t0 = time.perf_counter()
    with contextlib.chdir(base):
        _model, history, path = ttrain.main(["--train_data_dir", data, "--train_data_names",
                                             "labelled", "--n_epochs", str(TRAIN_EPOCHS),
                                             "--device", "cuda"])
    wall = time.perf_counter() - t0
    mse, dummy = history["test"][-1], history["third"][-1]
    rec = {"stage": "train", "rows": TRAIN_N, "features": 2 * STAGE_D, "epochs": TRAIN_EPOCHS,
           "steps": history["steps"], "train_s": history["seconds"],
           "steps_per_s": history["steps"] / history["seconds"], "cli_s": wall,
           "test_mse": mse, "dummy_mse": dummy}
    print(f"phase 16 train CLI: {TRAIN_N} rows x {2 * STAGE_D} features, {history['steps']} "
          f"steps in {history['seconds']:.2f} s = {rec['steps_per_s']:.0f} steps/s "
          f"({wall:.2f} s with loading and saving); test MSE {mse:.4f} against the dummy "
          f"baseline's {dummy:.4f}", flush=True)
    if not mse < 0.5 * dummy:
        fail(f"train: test MSE {mse} is not under half the dummy baseline's {dummy}")

    cfg = TrainConfig(dropout_prob=0.0, n_epochs=3)
    np.random.seed(cfg.random_seed)
    x_all, y_all, models = ttrain.load_training_data(data, ["labelled"], ["all"],
                                                     list(cfg.crop_names), False)
    targets, _ = ttrain._prepare_labels(y_all, cfg)
    _test_idx, train_idx = ttrain._split(len(x_all), cfg)
    xp, yp, wp = ttrain._pad_to_batches(x_all[train_idx], targets[train_idx], cfg.batch_size)
    meta = ttrain._make_meta(x_all, y_all, cfg, models, None)
    cpu_gen = torch.Generator().manual_seed(160)
    perms = [torch.randperm(len(xp), generator=cpu_gen) for _ in range(cfg.n_epochs)]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = SimpleFCRegressor.create(meta, cfg.random_seed, dev)
        opt = ttrain.make_optimizer(model, cfg)
        x, y, w = (torch.from_numpy(a).to(dev) for a in (xp, yp, wp))
        t0 = time.perf_counter()
        for epoch, perm in enumerate(perms):
            loss = ttrain._train_epoch(model, opt, x, y, w, perm.to(dev),
                                       ttrain._lr_at_epoch(epoch, cfg), cfg.batch_size, 0, None)
        runs[dev] = (model.params(), loss.item(), time.perf_counter() - t0)
    err = max(float(np.abs(p[k] - q[k]).max())
              for p, q in zip(runs["cuda"][0], runs["cpu"][0]) for k in ("kernel", "bias"))
    rec.update(card_vs_cpu_param_err=err, card_3_epochs_s=runs["cuda"][2],
               cpu_3_epochs_s=runs["cpu"][2], phase_s=time.perf_counter() - t_phase)
    print(f"phase 16 card vs CPU: 3 epochs without dropout in the same permutations, "
          f"parameters within {err:.3g} (loss {runs['cuda'][1]:.6f} / {runs['cpu'][1]:.6f}; "
          f"card {runs['cuda'][2]:.2f} s, CPU {runs['cpu'][2]:.2f} s); phase "
          f"{rec['phase_s']:.1f} s", flush=True)
    if not err <= 1e-5:
        fail(f"train: card and CPU parameters differ by {err} after 3 epochs")
    return {"record": rec, "path": os.path.join(base, path)}


PREDICT_TIMING = re.compile(
    r"predict timing: (\d+) rows in ([\d.]+) s \(([\d,]+) rows/s; gather ([\d.]+) s, "
    r"forward ([\d.]+) s, side_effects ([\d.]+) s")


def cli_imports(proc) -> set:
    """Top-level modules a ``python -X importtime`` run imported."""
    return {ln.split("|")[-1].strip().split(".")[0] for ln in proc.stderr.splitlines()
            if ln.startswith("import time:")}


def forbidden_imports(proc) -> set:
    """pandas, scikit-learn, JAX or the JAX package among the imports a CLI
    run tried (``-X importtime`` lists a failed import too). matplotlib is
    not among them: predict tries it for its optional histogram and goes on
    without."""
    return cli_imports(proc) & {"pandas", "sklearn", "jax", "clip_assisted_data_labeling_tpu"}


def predict_at_scale(base: str, ckpt: str) -> dict:
    """Phase 17: the predict CLI at N = PREDICT_N rows, in a process of its
    own for each wire. A float16 store of ViT-L-14-336 (4 crops of 768,
    0.8 GB), a baseline gray JPEG of a seeded size for each row (predict
    never decodes it; subset reads its header), a .json for every 16th row
    and human labels on the first N_LABELLED. On each wire: every row in the
    CSV with its label kept, the .json writeback, the preview copies that
    the CLI's seeded picks name, and the scores within 1e-5 of the same wire
    computed by the port on the CPU from the same store; rows/s with the
    gather, forward and side effects' seconds from the CLI's timing line.
    Returns the records, what phase 19 needs, and for phase 39 each wire's
    scores in listing order with the features."""
    from clip_assisted_data_labeling_tpu_torch.data.imsize import gray_jpeg_bytes
    from clip_assisted_data_labeling_tpu_torch.pipeline.predict import (
        _gather_features,
        load_model,
    )
    from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase

    t_phase = time.perf_counter()
    root = os.path.join(base, "pool", "mydata")
    os.makedirs(root)
    uuids, _z = write_feature_store(root, PREDICT_N, 17)
    rng = np.random.default_rng(17)
    shapes = [tuple(int(v) for v in wh) for wh in rng.integers(16, 161, (64, 2))]
    blobs = [gray_jpeg_bytes(w, h) for w, h in shapes]
    sizes = {}
    for u, k in zip(uuids, rng.integers(0, len(shapes), PREDICT_N).tolist()):
        with open(os.path.join(root, u + ".jpg"), "wb") as f:
            f.write(blobs[k])
        sizes[u] = shapes[k]
    json_uuids = uuids[::16]
    for u in json_uuids:
        with open(os.path.join(root, u + ".json"), "w") as f:
            json.dump({"uuid": u}, f)
    labels = rng.integers(0, 10, N_LABELLED).astype(np.float64)
    write_labels(root, uuids, labels)
    setup_s = time.perf_counter() - t_phase
    listing = [os.path.splitext(f)[0] for f in os.listdir(root) if f.endswith(".jpg")]

    cpu_model = load_model(ckpt, "cpu")
    kept, feats = _gather_features(root, listing, cpu_model)
    if kept != listing:
        fail("predict: the CPU gather dropped rows")
    records, preview, scores = [], root + "_predicted_scores", {}
    for wire in PREDICT_WIRES:
        shutil.rmtree(preview, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-X", "importtime", "-m",
             "clip_assisted_data_labeling_tpu_torch.pipeline.predict", "--root_dir", root,
             "--model_file", ckpt, "--wire", wire],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"predict CLI ({wire}) exited {proc.returncode}: {proc.stderr[-2000:]}")
        if forbidden_imports(proc):
            fail(f"the predict CLI imported {sorted(forbidden_imports(proc))}")
        timing = PREDICT_TIMING.search(proc.stdout)
        if timing is None:
            fail(f"predict CLI ({wire}) printed no timing line: {proc.stdout[-1000:]}")
        db = LabelDatabase.load_or_create(root)
        pred = dict(zip(db.column("uuid"), db.column("predicted_label")))
        got = np.array([pred.get(u, np.nan) for u in listing])
        scores[wire] = got
        kept_labels = np.array([db.get_label(u) for u in uuids[:N_LABELLED]])
        if not (len(db) == PREDICT_N and np.isfinite(got).all()
                and np.array_equal(kept_labels, labels)):
            fail(f"predict ({wire}): {len(db)} CSV rows, {np.isfinite(got).sum()} finite "
                 "scores, or a human label changed")
        bad_json = 0
        for u in json_uuids:
            with open(os.path.join(root, u + ".json")) as f:
                bad_json += json.load(f).get("predicted_label") != pred[u]
        pick_rng, want_previews = np.random.default_rng(0), set()
        for s in range(0, len(listing), 512):
            batch = listing[s:s + 512]
            for u, take in zip(batch, pick_rng.random(len(batch)) < 0.01):
                if take:
                    want_previews.add(f"{pred[u]:.3f}_{u}.jpg")
        previews = set(os.listdir(preview)) if os.path.isdir(preview) else set()
        ref = cpu_model.predict(feats, wire=wire)
        err = float(np.abs(got - ref).max())
        n_rows, cli_wall, rate, gather, forward, side = (
            float(v.replace(",", "")) for v in timing.groups())
        rec = {"stage": "predict", "wire": wire, "rows": int(n_rows), "seconds": cli_wall,
               "rows_per_s": n_rows / cli_wall, "gather_s": gather, "forward_s": forward,
               "side_effects_s": side, "process_s": wall, "cpu_max_abs_err": err,
               "previews": len(previews), "json_rows": len(json_uuids)}
        records.append(rec)
        print(f"phase 17 predict CLI, {wire} wire: {int(n_rows)} rows in {cli_wall:.3f} s = "
              f"{rec['rows_per_s']:,.0f} rows/s (gather {gather:.3f} s on its thread, forward "
              f"{forward:.3f} s, side effects {side:.3f} s; the process {wall:.1f} s); scores "
              f"against the CPU's same wire within {err:.3g}; {len(previews)} previews, "
              f"{len(json_uuids) - bad_json}/{len(json_uuids)} .json rows written", flush=True)
        if not (err <= 1e-5 and bad_json == 0 and previews == want_previews and previews):
            fail(f"predict ({wire}): CPU error {err}, {bad_json} stale .json rows, previews "
                 f"{len(previews)} against {len(want_previews)} picked")
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s ({setup_s:.1f} s writing the "
          f"store, {PREDICT_N} JPEG headers and the CSV)", flush=True)
    return {"records": records, "root": root, "sizes": sizes, "json_uuids": set(json_uuids),
            "listing": listing, "feats": feats, "scores": scores}


def scorer_cli(png_dir: str, ckpt: str, phase15_rows: dict) -> dict:
    """Phase 18: the single-image scorer. ``predict_simple``'s CLI on four
    of phase 15's PNGs with phase 16's checkpoint (clip_models
    ViT-L-14-336/openai, centre_crop and subcrop2_0.1: 1536 inputs), its
    encoder in bfloat16 with the random weights phase 15's embed made from
    the model name: K1 24 times an image (one forward of 4 crops a layer)
    and no other kernel; scores finite in [0, 1]; the copies named with
    their scores; then each image's features within bf16's cosine limit
    (1e-3) of the crops phase 15's embed CLI wrote for the same file (at
    the bucketed canvas the embed chose; the scorer's is 1024). Returns the
    launch counts."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import decode_rgb
    from clip_assisted_data_labeling_tpu_torch.models.aesthetic import AestheticRegressor
    from clip_assisted_data_labeling_tpu_torch.pipeline import predict_simple

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_scorer_")
    try:
        imgs = os.path.join(base, "imgs")
        os.makedirs(imgs)
        for name in phase15_rows:
            shutil.copy(os.path.join(png_dir, name), imgs)
        reset_counts()
        t0 = time.perf_counter()
        scores = predict_simple.main(["--input_img_dir", imgs, "--model_path", ckpt,
                                      "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want = {k: 24 * len(phase15_rows) if k == "K1" else 0 for k in got}
        copies = sorted(os.listdir(imgs + "_aesthetic_scores"))
        want_copies = sorted(f"{v:.3f}_{os.path.basename(p)}" for p, v in scores.items())
        vals = np.array(list(scores.values()))
        print(f"phase 18 predict_simple CLI: {len(scores)} images in {wall:.2f} s (encoder "
              f"init included), scores {np.round(vals, 4).tolist()}; launches {got} (want "
              f"{want})", flush=True)
        if got != want:
            fail(f"scorer: launch counters {got}, expected {want}")
        if not (len(vals) == len(phase15_rows) and np.isfinite(vals).all()
                and ((vals >= 0) & (vals <= 1)).all() and copies == want_copies):
            fail(f"scorer: scores {vals}, copies {copies} (want {want_copies})")

        scorer = AestheticRegressor(ckpt, verbose=0, device="cuda")
        errs = []
        for name, row in phase15_rows.items():
            _score, feats = scorer.predict_score(decode_rgb(os.path.join(imgs, name)))
            for part, crop in zip(feats[0].reshape(2, -1), (0, 3)):  # centre, subcrop2
                ref = row[crop]
                errs.append(1.0 - float(part @ ref / (np.linalg.norm(part) * np.linalg.norm(ref))))
        print(f"phase 18 features against phase 15's embed rows: 1 - cosine max "
              f"{max(errs):.3g} over {len(errs)} crops; phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        if not max(errs) <= 1e-3:
            fail(f"scorer: features differ from the embed stage's (1 - cosine {max(errs)})")
        return got
    finally:
        shutil.rmtree(base, ignore_errors=True)


def subset_cli(predicted: dict) -> dict:
    """Phase 19: the subset CLI (in a process of its own) on phase 17's
    directory with scores in SUBSET_RANGE and SUBSET_MIN_PIXELS: the copied
    files are exactly those of the plain version, which rescales the human
    labels by the largest, takes the prediction elsewhere, and gates each
    row on the size phase 17 wrote into its JPEG header (aspect 0.25 to 4,
    pixels over the minimum), and the folder is named with their count."""
    from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase

    t0 = time.perf_counter()
    root, (lo, hi) = predicted["root"], SUBSET_RANGE
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "clip_assisted_data_labeling_tpu_torch.pipeline.subset", "--input_dir", root,
         "--min_score", str(lo), "--max_score", str(hi), "--min_n_pixels",
         str(SUBSET_MIN_PIXELS), "--extensions", ".jpg", ".json", ".txt"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"subset CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    if forbidden_imports(proc) | (cli_imports(proc) & {"torch"}):
        fail(f"the subset CLI imported {sorted(cli_imports(proc) & {'pandas', 'jax', 'torch'})}")

    db = LabelDatabase.load_or_create(root)
    labels, preds = db.column("label"), db.column("predicted_label")
    max_label = np.nanmax(labels)
    want = set()
    for u, label, pred in zip(db.column("uuid"), labels, preds):
        score = label / max_label if not np.isnan(label) else pred
        w, h = predicted["sizes"][u]
        if lo <= score <= hi and 0.25 <= w / h <= 4.0 and w * h > SUBSET_MIN_PIXELS:
            want.add(u + ".jpg")
            if u in predicted["json_uuids"]:
                want.add(u + ".json")
    n_imgs = sum(f.endswith(".jpg") for f in want)
    out = f"{root}_{lo:.2f}_to_{hi:.2f}_subset_{n_imgs}_imgs"
    got = set(os.listdir(out)) if os.path.isdir(out) else set()
    print(f"phase 19 subset CLI: {n_imgs} of {len(db)} rows copied with their .json files "
          f"({len(got)} files) in {wall:.2f} s (the process)", flush=True)
    if not (got == want and n_imgs > 0):
        fail(f"subset: {len(got)} files copied to {out}, the plain version {len(want)}")
    return {"stage": "subset", "rows": len(db), "copied_images": n_imgs, "files": len(got),
            "process_s": wall}


def stages(png_dir: str, phase15_rows: dict,
           base: str) -> tuple[list[dict], dict, dict, str]:
    """Phases 16-19 in ``base``, a directory of their own (the caller removes
    it; phase 42 searches phase 17's store): train (and phase 35, train with
    --debug_nans), predict on every wire, the single-image scorer, subset,
    then phase 39 (predict over a mesh) on predict's directory. Returns the
    records, the scorer's launch counts, phase 39's record and predict's
    directory."""
    trained = train_on_card(base)
    debug_nans = train_debug_nans(base)  # phase 35, on phase 16's store
    predicted = predict_at_scale(base, trained["path"])
    scorer = scorer_cli(png_dir, trained["path"], phase15_rows)
    subset = subset_cli(predicted)
    sharded = sharded_predict(predicted, trained["path"])  # phase 39
    return ([trained["record"], debug_nans, *predicted["records"], subset], scorer, sharded,
            predicted["root"])


# --- phases 20-23: the rest of the active-learning loop ------------------------------
HEX32 = re.compile(r"[0-9a-f]{32}")
DIVERSITY_NS = (262144, 1048576)  # phase 14's N, and the north star's
DIVERSITY_ORDER, DIVERSITY_CANDIDATES = 500, 100  # the label stage's prefix and sample
LOOP_N, LOOP_KEYS, LOOP_LAPS = 8192, 100, 3
SHOWN = re.compile(r"^headless (.+?): (\d+) frames shown: (.*)$", re.M)


def run_cli(module: str, args: list, label: str, timeout: int = 600,
            also_forbidden: frozenset = frozenset(), cwd: str | None = None) -> tuple:
    """``python -X importtime -m <module> <args>`` from the repository root
    (or from ``cwd``, with the repository on the path) in a process of its
    own; fails on a nonzero exit, or where it imported pandas, JAX, the JAX
    package or any of ``also_forbidden``. Returns the process and its
    seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", module, *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, cwd=cwd or repo,
                          env=dict(os.environ, PYTHONPATH=repo) if cwd else None)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label} CLI exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-2000:]}")
    bad = forbidden_imports(proc) | (cli_imports(proc) & also_forbidden)
    if bad:
        fail(f"the {label} CLI imported {sorted(bad)}")
    return proc, wall


def prep_cli(png_dir: str) -> dict:
    """Phase 20: stage 0. The prep CLI in copy mode on phase 4's PNGs plus a
    .txt prompt beside two of them, in a process of its own: every file
    copied byte for byte under a 32-hex-digit uuid name, each basename
    group under one uuid, the natural-sort order of the groups kept by
    their uuids, and no PIL imported (no file needs a resize: sizes come
    from the PNG headers)."""
    from clip_assisted_data_labeling_tpu_torch.utils.naming import natural_sort

    base = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        raw, out = os.path.join(base, "raw"), os.path.join(base, "prepped")
        os.makedirs(raw)
        for i in range(N_IMAGES):
            shutil.copy(os.path.join(png_dir, f"img_{i:03d}.png"), raw)
        for i in (2, 17):
            with open(os.path.join(raw, f"img_{i:03d}.txt"), "w") as f:
                f.write(f"a prompt for image {i}\n")
        proc, wall = run_cli("clip_assisted_data_labeling_tpu_torch.pipeline.prep",
                             ["--root_dir", raw, "--output_dir", out, "--mode", "copy"],
                             "prep", also_forbidden=frozenset({"PIL", "matplotlib"}))

        def contents(d):
            got = {}
            for name in os.listdir(d):
                with open(os.path.join(d, name), "rb") as f:
                    got[name] = f.read()
            return got

        src, dst = contents(raw), contents(out)
        by_bytes = {v: k for k, v in dst.items()}
        uuid_of = {}
        for name, data in src.items():
            stem, ext = os.path.splitext(name)
            copy = by_bytes.get(data)
            if copy is None or os.path.splitext(copy)[1] != ext or not HEX32.fullmatch(
                    os.path.splitext(copy)[0]):
                fail(f"prep: {name} has no byte-identical copy under a uuid name ({copy})")
            uuid_of.setdefault(stem, set()).add(os.path.splitext(copy)[0])
        groups_ok = all(len(u) == 1 for u in uuid_of.values())
        stems = natural_sort(list(uuid_of))
        ordered = [next(iter(uuid_of[s])) for s in stems]
        done = [ln for ln in proc.stdout.splitlines() if ln.startswith("Prep done:")]
        print(f"phase 20 prep CLI: {len(src)} files in {len(stems)} groups copied in "
              f"{wall:.2f} s (the process); {done}", flush=True)
        if not (len(dst) == len(src) and groups_ok and ordered == natural_sort(ordered)):
            fail(f"prep: {len(dst)} files out of {len(src)}, groups sharing a uuid "
                 f"{groups_ok}, natural order kept {ordered == natural_sort(ordered)}")
        return {"stage": "prep", "files": len(src), "groups": len(stems), "process_s": wall}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def store_rebuild(droot: str) -> dict:
    """Phase 21: the store CLI's ``rebuild`` on the .pt sidecars phase 15's
    embed wrote (copied to a fresh directory, without the store), in a
    process of its own: the rebuilt store's rows equal the embed-written
    store's, per uuid, in every crop, every stat and the valid flag; then
    ``info`` prints one line for its one model."""
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore

    base = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        ds = os.path.join(base, "mydata")
        os.makedirs(ds)
        for name in os.listdir(droot):
            if name.endswith(".pt"):
                shutil.copy(os.path.join(droot, name), ds)
        module = "clip_assisted_data_labeling_tpu_torch.pipeline.store"
        _proc, wall = run_cli(module, ["rebuild", "--root_dir", ds], "store rebuild",
                              also_forbidden=frozenset({"matplotlib"}))
        info, _ = run_cli(module, ["info", "--root_dir", ds], "store info")
        want, got = EmbeddingStore.open(droot, MODEL), EmbeddingStore.open(ds, MODEL)
        rows = [(want.index_of(u), got.index_of(u)) for u in want.uuids]
        w, g = np.array([r[0] for r in rows]), np.array([r[1] for r in rows])
        same = (sorted(want.uuids) == sorted(got.uuids)
                and want.meta["crop_names"] == got.meta["crop_names"]
                and np.array_equal(np.asarray(want.embeddings)[w], np.asarray(got.embeddings)[g])
                and np.array_equal(np.asarray(want.img_stats)[w], np.asarray(got.img_stats)[g])
                and np.array_equal(np.asarray(want.valid)[w], np.asarray(got.valid)[g]))
        lines = info.stdout.strip().splitlines()
        print(f"phase 21 store CLI: rebuilt {len(rows)} rows of {MODEL} from sidecars in "
              f"{wall:.2f} s (the process); equal to the embed's store: {same}; info: {lines}",
              flush=True)
        if not (same and len(rows) == 8 and len(lines) == 1 and lines[0].startswith(f"[{MODEL}]")):
            fail("store: the rebuilt store differs from the embed's, or info printed "
                 f"{lines}")
        return {"stage": "store", "rows": len(rows), "process_s": wall}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def replay_picks(x64: torch.Tensor, prefix: np.ndarray, draws: torch.Tensor | None):
    """The card's picks replayed in float64 on the card: at each step i ≥ 1
    the pick's maxsim less the float64 minimum (over every row, or over the
    step's draws), and the float64 argmin. Returns (excess [n-1], argmins
    [n-1]) on the host."""
    picks = torch.from_numpy(prefix).cuda()
    maxsim = torch.mv(x64, x64[picks[0]])
    maxsim[picks[0]] = float("inf")
    excess = torch.empty(len(prefix) - 1, dtype=torch.float64, device="cuda")
    argmin = torch.empty(len(prefix) - 1, dtype=torch.int64, device="cuda")
    for i in range(1, len(prefix)):
        pool = maxsim if draws is None else maxsim[draws[i - 1]]
        best = torch.argmin(pool)
        argmin[i - 1] = best if draws is None else draws[i - 1][best]
        excess[i - 1] = maxsim[picks[i]] - pool[best]
        torch.maximum(maxsim, torch.mv(x64, x64[picks[i]]), out=maxsim)
        maxsim[picks[i]] = float("inf")
    return excess.cpu().numpy(), argmin.cpu().numpy()


def diversity_at_scale() -> list[dict]:
    """Phase 22: the farthest-point order at a real size. Seeded embeddings
    of width STAGE_D (ViT-L-14-336's) at N = 262,144 and 1,048,576, 500
    picks, exact and sampled (100 candidates a step, the function's own
    draws from its seed), each timed in two parts (host normalization and
    upload; the device loop up to the prefix on the host) with its peak
    device memory. Checked by replaying the card's picks in float64 on the
    card: each exact pick's maxsim within 1e-5 of the float64 minimum over
    every row, each sampled pick within 1e-5 of it over its own draws (and
    among them); no repeat in the prefix; the tail the other indices in
    order. Prints the first step where a pick differs from the float64
    argmin."""
    from clip_assisted_data_labeling_tpu_torch.ops.diversity import (
        draw_candidates,
        farthest_point_order,
    )
    from clip_assisted_data_labeling_tpu_torch.ops.similarity import normalize_rows
    from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

    farthest_point_order(np.random.default_rng(22).normal(size=(4096, STAGE_D)), n_order=50,
                         device="cuda")
    records = []
    for n in DIVERSITY_NS:
        gen = torch.Generator(device="cuda").manual_seed(22)
        emb = torch.randn((n, STAGE_D), generator=gen, device="cuda").cpu().numpy()
        runs = {}
        for candidates in (None, DIVERSITY_CANDIDATES):
            timer = StageTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            order = farthest_point_order(emb, n_order=DIVERSITY_ORDER, candidates=candidates,
                                         seed=22, device="cuda", timer=timer)
            runs[candidates] = (order, timer.totals, time.perf_counter() - t0,
                                torch.cuda.max_memory_allocated() / 1e9)
        # the replay, in float64 on the card, after the timed runs
        x64 = torch.from_numpy(normalize_rows(emb)).cuda().double()
        for candidates, (order, parts, total, peak) in runs.items():
            form = "exact" if candidates is None else "sampled"
            prefix, tail = order[:DIVERSITY_ORDER], order[DIVERSITY_ORDER:]
            draws = (None if candidates is None else
                     draw_candidates(n, DIVERSITY_ORDER, candidates, 22, "cuda"))
            excess, argmin = replay_picks(x64, prefix, draws)
            in_draws = draws is None or all(
                int(p) in set(d) for p, d in zip(prefix[1:], draws.cpu().numpy().tolist()))
            tail_ok = np.array_equal(tail, np.setdiff1d(np.arange(n), prefix))
            repeats = DIVERSITY_ORDER - len(set(prefix.tolist()))
            differ = np.nonzero(argmin != prefix[1:])[0]
            first = int(differ[0]) + 1 if len(differ) else None
            rec = {"stage": "diversity", "form": form, "n": n, "d": STAGE_D,
                   "n_order": DIVERSITY_ORDER, "candidates": candidates, "seconds": total,
                   "prepare_s": parts["prepare"], "order_s": parts["order"], "peak_gb": peak,
                   "max_excess": float(excess.max()), "first_step_off_f64_argmin": first,
                   "steps_off_f64_argmin": len(differ)}
            records.append(rec)
            print(f"phase 22 diversity {form}, N={n} D={STAGE_D}: {total:.3f} s (host "
                  f"normalization and upload {rec['prepare_s']:.3f} s, device loop "
                  f"{rec['order_s']:.3f} s), peak {peak:.2f} GB; float64 replay: picks within "
                  f"{rec['max_excess']:.3g} of the minimum, first step off the float64 argmin: "
                  f"{'none' if first is None else first} ({len(differ)} steps)", flush=True)
            if not (repeats == 0 and in_draws and tail_ok and rec["max_excess"] <= 1e-5):
                fail(f"diversity {form} N={n}: excess {rec['max_excess']}, {repeats} repeats, "
                     f"picks in their draws {in_draws}, tail in order {tail_ok}")
        del x64, emb
        torch.cuda.empty_cache()
    return records


def _shown(stdout: str) -> dict:
    """session name → the uuids a headless session showed, in order."""
    return {m.group(1): m.group(3).split(",") for m in SHOWN.finditer(stdout)}


def _expected_session(order: list[str], labels: dict, n_keys: int) -> list[str]:
    """What a headless session of ``n_keys`` digit keys then a quit shows on
    ``order``: the labelled images skipped from the start up to the first
    unlabelled one, then n_keys + 1 images in turn."""
    p = 0
    while order[p] in labels:
        p += 1
    return [order[(p + i) % len(order)] for i in range(n_keys + 1)]


def loop_cli() -> dict:
    """Phase 23: the active-learning loop on the card. LOOP_N images of
    64x64 under .jpg names (PNG streams: the card's machine has no JPEG
    codec to promise; the label stage globs .jpg only, and cv2.imread, the
    JAX package's reader, decodes by content as the port's decode chain
    does), a float16 store of MODEL's 4 crops with a planted latent (as
    phase 16's) and a CSV of every row unlabelled. The loop CLI in a
    process of its own: --laps 3 --sort middle --backend headless, 100
    keys a lap, each 0 or 9 (lap 1's follow the sign of the latent of the
    rows it shows, the database order; laps 2 and 3 drawn from a seed).
    Checks: 100, 200 and 300 labels; every row predicted each lap, a
    checkpoint each lap; each
    lap's shown uuids as ``re_order_images`` orders the database the lap
    before, rebuilt here from the earlier laps' keys and the earlier
    checkpoint's scores on the card in the CLI's batches (held against the
    backup lap 3 took of the CSV); seconds a lap in label, train and
    predict. Then one label CLI session with --sort diversity on the first
    CSV: its first 100 uuids are ``farthest_point_order`` of the store's
    square_padded_crop rows computed here on the card."""
    from clip_assisted_data_labeling_tpu_torch.data.png import write_png
    from clip_assisted_data_labeling_tpu_torch.ops.diversity import farthest_point_order
    from clip_assisted_data_labeling_tpu_torch.pipeline.predict import (
        _gather_features,
        load_model,
    )
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.database import (
        LabelDatabase,
        database_path_for,
    )
    from clip_assisted_data_labeling_tpu_torch.ui.sorting import re_order_images
    from clip_assisted_data_labeling_tpu_torch.utils.naming import natural_sort

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        root = os.path.join(base, "data", "loopset")
        os.makedirs(root)
        uuids, z = write_feature_store(root, LOOP_N, 23)
        rng = np.random.default_rng(23)
        ramp = np.linspace(0, 255, 64)
        for i, u in enumerate(uuids):
            img = np.empty((64, 64, 3), np.uint8)
            img[..., 0], img[..., 1] = ramp[None, :], ramp[:, None]
            img[..., 2] = i % 256
            write_png(os.path.join(root, u + ".jpg"), img)
        csv_path = database_path_for(root)
        nan = np.full(LOOP_N, np.nan)
        LabelDatabase({"uuid": uuids, "label": nan, "timestamp": nan,
                       "predicted_label": nan}, csv_path).save()
        first_csv = os.path.join(base, "first.csv")
        shutil.copy(csv_path, first_csv)
        setup_s = time.perf_counter() - t_phase

        # keys 0 and 9 only: the middle order ranks rows by |prediction − median|,
        # and a labelled row's prediction is its label (fix_database), so labels
        # far from the median keep every labelled row behind the first 100
        # unlabelled ones; with labels of 4 and 5 a lap re-showed and relabelled
        # 21 labelled images (a card run), as the reference's navigation does
        keys = [np.where(z[:LOOP_KEYS] + rng.normal(0, 0.25, LOOP_KEYS) > 0, 9, 0)]
        keys += [rng.choice([0, 9], LOOP_KEYS) for _ in range(LOOP_LAPS - 1)]
        script = ";".join(",".join(map(str, k)) for k in keys)
        models = os.path.join(base, "models")
        proc, wall = run_cli("clip_assisted_data_labeling_tpu_torch.pipeline.loop",
                             ["--root_dir", root, "--laps", LOOP_LAPS, "--sort", "middle",
                              "--backend", "headless", "--keys", script, "--models_dir",
                              models, "--device", "cuda"], "loop", timeout=900)
        out = proc.stdout
        laps = [tuple(map(int, m)) for m in re.findall(r"^Lap \d+/\d+: (\d+) labels, (\d+) "
                                                       r"predictions", out, re.M)]
        timing = [tuple(map(float, m)) for m in re.findall(
            r"^lap \d+ timing: label ([\d.]+) s, train ([\d.]+) s, predict ([\d.]+) s", out,
            re.M)]
        ckpts = re.findall(r"^Final model saved as: (.+)$", out, re.M)
        shown = _shown(out)
        db = LabelDatabase.load_or_create(root)
        want_laps = [(LOOP_KEYS * (k + 1), LOOP_N) for k in range(LOOP_LAPS)]
        if not (laps == want_laps and len(ckpts) == LOOP_LAPS and len(timing) == LOOP_LAPS
                and all(os.path.exists(c) for c in ckpts)
                and db.n_labeled() == LOOP_KEYS * LOOP_LAPS
                and np.isfinite(db.column("predicted_label")).all()):
            fail(f"loop: laps {laps} (want {want_laps}), checkpoints {ckpts}, timing {timing}, "
                 f"{db.n_labeled()} labels: {out[-2000:]}")

        files = natural_sort([os.path.join(root, u + ".jpg") for u in uuids])
        listing = [os.path.splitext(f)[0] for f in os.listdir(root) if f.endswith(".jpg")]
        labels: dict = {}
        backup = [f for f in os.listdir(os.path.dirname(root)) if "_db_backup_" in f]
        orders_ok, backup_ok = [], False
        for lap in range(LOOP_LAPS):
            if lap == 0:
                order = uuids  # no prediction yet: the database's order
            else:  # the database after the lap before, rebuilt
                model = load_model(ckpts[lap - 1], "cuda")
                kept, feats = _gather_features(root, listing, model)
                scores = np.concatenate([model.predict(feats[s:s + 512], wire="float16")
                                         for s in range(0, len(kept), 512)])
                pred = dict(zip(kept, scores.astype(np.float64)))
                lab = np.array([labels.get(u, np.nan) for u in uuids])
                state = LabelDatabase({"uuid": uuids, "label": lab, "timestamp": nan,
                                       "predicted_label": np.array([pred[u] for u in uuids])},
                                      csv_path)
                if lap == LOOP_LAPS - 1 and len(backup) == 1:  # lap 3's own backup
                    saved = LabelDatabase.load_or_create(
                        os.path.join(os.path.dirname(root), backup[0])[:-len(".csv")])
                    backup_ok = (saved.column("uuid") == uuids and np.array_equal(
                        saved.column("label"), lab, equal_nan=True) and np.array_equal(
                        saved.column("predicted_label"), state.column("predicted_label")))
                state.fix_database()
                order = [os.path.splitext(os.path.basename(f))[0]
                         for f in re_order_images(files, state, root, "middle", "cuda")]
            want = _expected_session(order, labels, LOOP_KEYS)
            got = shown.get(f"lap {lap + 1}", [])
            orders_ok.append(got == want)
            for u, k in zip(got, keys[lap]):
                labels[u] = k / 10.0
        records = {"stage": "loop", "rows": LOOP_N, "laps": LOOP_LAPS, "process_s": wall,
                   "setup_s": setup_s,
                   "lap_s": [{"label": a, "train": b, "predict": c} for a, b, c in timing]}
        print(f"phase 23 loop CLI: {LOOP_LAPS} laps on {LOOP_N} rows, labels "
              f"{[n for n, _ in laps]}, {LOOP_N} predicted each lap, in {wall:.1f} s (the "
              f"process; writing the images, store and CSV took {setup_s:.1f} s); per lap "
              f"label/train/predict seconds {timing}; shown orders as re-sorted: {orders_ok}; "
              f"rebuilt lap-3 database equal to its backup: {backup_ok}", flush=True)
        if not (all(orders_ok) and backup_ok):
            fail(f"loop: shown orders {orders_ok}, backup equal {backup_ok}")

        shutil.copy(first_csv, csv_path)
        session, dwall = run_cli(
            "clip_assisted_data_labeling_tpu_torch.pipeline.label",
            ["--root_dir", root, "--sort", "diversity", "--backend", "headless", "--keys",
             ",".join(map(str, keys[0])), "--device", "cuda"], "label",
            also_forbidden=frozenset({"matplotlib"}))
        store = EmbeddingStore.open(root, MODEL)
        rows = np.array([store.index_of(os.path.splitext(os.path.basename(f))[0])
                         for f in files])
        emb = np.asarray(store.embeddings[rows, store.crop_index("square_padded_crop")],
                         np.float32)
        order = farthest_point_order(emb, n_order=min(DIVERSITY_ORDER, len(emb)), device="cuda")
        want = [os.path.splitext(os.path.basename(files[i]))[0] for i in order[:LOOP_KEYS]]
        got = _shown(session.stdout).get("session", [])
        print(f"phase 23 label CLI, --sort diversity: {len(got)} frames in {dwall:.1f} s (the "
              f"process); first {LOOP_KEYS} equal to farthest_point_order on the card: "
              f"{got[:LOOP_KEYS] == want}; phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        if got[:LOOP_KEYS] != want:
            fail("label --sort diversity: the shown order is not the farthest-point order")
        records["diversity_session_s"] = dwall
        return records
    finally:
        shutil.rmtree(base, ignore_errors=True)


# --- phases 36-40: the parallel layer ------------------------------------------------
# a repeated device makes a mesh on the one card: its shards run one after
# another there, so these phases measure correctness and launches, not scaling
DP_DEVICES, RING_DEVICES = 2, 4
PARALLEL_TIMEOUT_S = 600  # each spawned process of phase 40


def check_parallel_kernels(xgen: torch.Generator) -> list[dict]:
    """Phase 3, the parallel layer's shard shapes (inputs from ``xgen``):
    K1 bf16 at phase 36's data-parallel shard of ViT-L-14-336 (4 images x 4
    crops: [16, 577, 3072]) and at phase 37's tensor-parallel shard of it (8
    heads of 64: [16, 577, 1536], in int8_static and bfloat16), K2 at both
    phases' rows [9232, 1024], K3 at SO400M-384's tensor-parallel shard (8
    heads of 72: [16, 729, 1728])."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    l336, so400m = resolve_config(MODEL), resolve_config(SIGLIP)
    bf16 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)
    half = dataclasses.replace(l336, width=l336.width // 2, heads=l336.heads // 2)
    rows = [attention_case("K1", l336, 16, bf16, False, ("dp_l336", "K1"), xgen),
            attention_case("K1", half, 16, bf16, False, ("tp_l336_all", "K1"), xgen)]
    g = 1 + 0.1 * torch.randn((l336.width,), generator=xgen, device="cuda")
    bta = 0.1 * torch.randn((l336.width,), generator=xgen, device="cuda")
    rows.append(rowquant_static_case(16 * 577, l336.width, g, bta,
                                     torch.tensor([6.0], device="cuda"),
                                     ("l336_parallel", "K2"), xgen))
    rows.append(q8s_case(16, so400m.seq_len, so400m.width // 2, so400m.heads // 2,
                         ("tp_so400m", "K3"), xgen))
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


def read_sides(root: str, model: str, names: list) -> np.ndarray:
    """The sidecars' crops of ``names`` (PNG basenames) → [n, 4, D]."""
    from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    return np.stack([np.stack([read_sidecar(os.path.join(root, n[:-4] + ".pt"))[model][c]
                               .reshape(-1) for c in ALL_CROPS]) for n in names])


def cos_err(a: np.ndarray, b: np.ndarray) -> float:
    """1 − the least cosine between matching rows of a and b."""
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    cos = np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return float(1.0 - cos.min())


def dp_embed(root: str, l336: dict) -> dict:
    """Phase 36: ``embed_dataset`` with a mesh of the card listed
    DP_DEVICES times, on copies of the PNGs with phase 5's .calib.npz beside
    them: ViT-L-14-336/openai int8_static at full width and depth, each
    batch of BATCH split into DP_DEVICES shard forwards. The counters
    (zeroed just before, read just after): K1 once and K2 twice a layer a
    shard forward, nothing else; the calibration file left as it was; every
    crop within 1 − cosine 1e-5 of phase 5's, the max abs difference
    printed."""
    from clip_assisted_data_labeling_tpu_torch.config import EmbedConfig
    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config
    from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import embed_dataset

    cfg = resolve_config(MODEL)
    droot = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        names = [os.path.basename(p)[:-3] + ".png" for p in l336["pts"]]
        for n in names:
            shutil.copy(os.path.join(root, n), droot)
        calib = MODEL.replace("/", "-") + ".calib.npz"
        shutil.copy(os.path.join(root, calib), droot)
        with open(os.path.join(droot, calib), "rb") as f:
            published = f.read()
        mesh = get_mesh(devices=["cuda:0"] * DP_DEVICES)
        reset_counts()
        t0 = time.perf_counter()
        embed_dataset(droot, EmbedConfig(models_to_use=(MODEL,), batch_size=BATCH,
                                         num_workers=4, device="cuda"), mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        forwards = math.ceil(N_IMAGES / BATCH) * DP_DEVICES
        want = {k: {"K1": cfg.layers, "K2": 2 * cfg.layers}.get(k, 0) * forwards for k in got}
        side = read_sides(droot, MODEL, names)
        err = cos_err(side, l336["side"])
        diff = float(np.abs(side - l336["side"]).max())
        with open(os.path.join(droot, calib), "rb") as f:
            same_calib = f.read() == published
        print(f"phase 36 data-parallel embed over {mesh}: {N_IMAGES} images in {wall:.2f} s "
              f"({forwards} shard forwards of {BATCH // DP_DEVICES} images); launches {got} "
              f"(want {want}); against phase 5: 1 - cosine max {err:.3g}, max abs {diff:.3g}; "
              f"calibration unchanged: {same_calib}", flush=True)
        if got != want or not same_calib or not err <= 1e-5:
            fail(f"phase 36: launches {got} (want {want}), 1 - cosine {err}, calibration "
                 f"unchanged {same_calib}")
        return {"launches": got, "record": {"phase": 36, "path": "data-parallel embed",
                                             "model": MODEL, "devices": DP_DEVICES,
                                             "seconds": wall, "cos_err": err,
                                             "max_abs_diff": diff}}
    finally:
        shutil.rmtree(droot, ignore_errors=True)


def tensor_parallel(root: str, pts: list) -> tuple[dict, list[dict]]:
    """Phase 37: a (1, 2) mesh of the card listed twice; for each tower the
    same encoder's single-device forward on 4 images x 4 crops against the
    tensor-parallel one with the same weights and scales: ViT-L-14-336
    int8_static at full depth (K2 on the replicated stream, twice a layer;
    K1 at 8 heads a shard), ViT-SO400M-14-SigLIP-384 int8_static at full
    depth (the int8 wire: K3 at the local width 3·w/2), each bit-equal
    (``torch.equal``) where every shard's route is the single device's, else
    within 1 − cosine 2e-3 (the routes printed); ViT-L-14-336 bfloat16 (K1
    at 8 heads a shard) within 1 − cosine 1e-3. The TP forward's counters
    are exact; each forward's steady ms beside the single device's."""
    from clip_assisted_data_labeling_tpu_torch.data.loader import BatchedImageLoader
    from clip_assisted_data_labeling_tpu_torch.models.encoders import CLIPImageEncoder
    from clip_assisted_data_labeling_tpu_torch.models.vit import vit_encode_image
    from clip_assisted_data_labeling_tpu_torch.ops.crops import fused_crop_resize_normalize
    from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh_2d
    from clip_assisted_data_labeling_tpu_torch.parallel.tp import apply_tp_sharding, vit_encode_tp
    from clip_assisted_data_labeling_tpu_torch.parallel.tp_static import (
        place_tp_static,
        tp_static_routes,
        vit_encode_tp_static,
    )

    mesh = get_mesh_2d(1, 2, devices=["cuda:0"] * 2)
    launches, records = {}, []
    for path, model, dtype in (("tp_l336", MODEL, "int8_static"),
                               ("tp_so400m", SIGLIP, "int8_static"),
                               ("tp_l336_bf16", MODEL, "bfloat16")):
        t_tower = time.perf_counter()
        enc = CLIPImageEncoder(model, compute_dtype=dtype, device="cuda")
        cfg = enc.cfg
        loader = BatchedImageLoader([p[:-3] + ".png" for p in pts[:4]], canvas_size=1024,
                                    out_size=cfg.image_size, batch_size=4, num_workers=4)
        batch = next(iter(loader))
        crops = fused_crop_resize_normalize(
            torch.from_numpy(batch.canvas).cuda(), torch.from_numpy(batch.crop_params).cuda(),
            out_size=cfg.image_size, parity=enc.parity_preprocess, dtype=enc.compute_dtype,
            mean=cfg.norm_mean, std=cfg.norm_std)
        flat = crops.reshape((-1,) + crops.shape[2:])
        static = dtype == "int8_static"
        if static:
            enc._maybe_calibrate(flat)
            routes = tp_static_routes(cfg, 2, enc.wire)
            tpm = place_tp_static(enc.model, mesh, cfg)
            fn = vit_encode_tp_static
        else:
            routes = None
            tpm = apply_tp_sharding(enc.model, mesh)
            fn = vit_encode_tp
        single = vit_encode_image(enc.model, flat, enc.compute_dtype)
        reset_counts()
        got = fn(tpm, flat, enc.compute_dtype)
        torch.cuda.synchronize()
        c = counts()
        want = {k: 0 for k in c}
        if static and enc.wire:
            want["K3"] = 2 * cfg.layers
        else:
            want["K1"] = 2 * cfg.layers
            if static:
                want["K2"] = 2 * cfg.layers
        launches[path] = c
        equal = torch.equal(got, single)
        err = cos_err(got.cpu().numpy(), single.cpu().numpy())
        diff = (got - single).abs().max().item()
        single_ms = time_ms(lambda: vit_encode_image(enc.model, flat, enc.compute_dtype),
                            min_reps=3, min_s=0.3)
        tp_ms = time_ms(lambda: fn(tpm, flat, enc.compute_dtype), min_reps=3, min_s=0.3)
        print(f"phase 37 tensor parallel {model} {dtype} over {mesh}: routes (single, shard) "
              f"{routes}; torch.equal {equal}, 1 - cosine {err:.3g}, max abs {diff:.3g}; "
              f"launches {c} (want {want}); {single_ms:.3f} ms single, {tp_ms:.3f} ms TP a "
              f"forward of 16 crops; {time.perf_counter() - t_tower:.1f} s", flush=True)
        if c != want:
            fail(f"phase 37 {model} {dtype}: launches {c}, expected {want}")
        if static and routes[0] == routes[1]:
            ok = equal
        else:
            ok = err <= (2e-3 if static else 1e-3)
        if not ok:
            fail(f"phase 37 {model} {dtype}: TP against single device: equal {equal}, "
                 f"1 - cosine {err}, routes {routes}")
        records.append({"phase": 37, "path": "tensor parallel", "model": model, "dtype": dtype,
                        "routes": routes, "equal": equal, "cos_err": err, "max_abs_diff": diff,
                        "single_ms": single_ms, "tp_ms": tp_ms})
        del enc, tpm, single, got, crops, flat
        torch.cuda.empty_cache()
    return launches, records


def ring_dedup(phase14: dict) -> list[dict]:
    """Phase 38: ``find_duplicate_pairs_sharded`` over a mesh of the card
    listed RING_DEVICES times, at phase 14's embeddings, on both wires: the
    pair set and the overflow rows equal to phase 14's, with the seconds of
    the host preparation, the ring's counts and the extract."""
    from clip_assisted_data_labeling_tpu_torch.parallel.dedup_sharded import (
        find_duplicate_pairs_sharded,
    )
    from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh
    from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

    mesh = get_mesh(devices=["cuda:0"] * RING_DEVICES)
    records = []
    for wire in ("int8", "fp16"):
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = find_duplicate_pairs_sharded(phase14["emb"], threshold=0.96, wire=wire,
                                           mesh=mesh, timer=timer)
        total = time.perf_counter() - t0
        got = set(zip(res.rows.tolist(), res.cols.tolist()))
        same = got == phase14["pairs"] and np.array_equal(res.overflow_rows,
                                                          phase14["overflow_rows"])
        rec = {"phase": 38, "path": "ring dedup", "n": len(phase14["emb"]), "wire": wire,
               "devices": RING_DEVICES, "seconds": total,
               **{f"{k}_s": v for k, v in timer.totals.items()}, "pairs": len(got),
               "same_as_phase_14": same}
        records.append(rec)
        print(f"phase 38 ring dedup, {wire} wire, N={len(phase14['emb'])} over {mesh}: "
              f"{total:.3f} s (prepare {rec['prepare_s']:.3f} s, counts {rec['counts_s']:.3f} s, "
              f"extract {rec.get('extract_s', 0.0):.3f} s); {len(got)} pairs, "
              f"{len(res.overflow_rows)} overflow rows; equal to phase 14: {same}", flush=True)
        if not same:
            fail(f"phase 38 {wire}: {len(got)} pairs against phase 14's "
                 f"{len(phase14['pairs'])}, or other overflow rows")
    return records


def sharded_predict(predicted: dict, ckpt: str) -> dict:
    """Phase 39: predict over a mesh of the card listed DP_DEVICES times at
    phase 17's rows: ``predict_labels(..., sharded=True, mesh=...)`` on the
    float32 wire (the whole stage, its CSV scores within 1e-6 of phase
    17's float32 CLI run: the float32 sums of a product of 65,536 / 2 rows
    may round otherwise than those of 512 rows), then ``predict_sharded`` on
    the float16 wire over the same features (within 2e-3 of phase 17's
    float16 run)."""
    from clip_assisted_data_labeling_tpu_torch.parallel.mesh import get_mesh
    from clip_assisted_data_labeling_tpu_torch.parallel.predict_sharded import predict_sharded
    from clip_assisted_data_labeling_tpu_torch.pipeline.predict import (
        load_model,
        predict_labels,
    )
    from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase

    mesh = get_mesh(devices=["cuda:0"] * DP_DEVICES)
    root, listing = predicted["root"], predicted["listing"]
    t0 = time.perf_counter()
    n = predict_labels(root, ckpt, wire="float32", device="cuda", sharded=True, mesh=mesh)
    wall = time.perf_counter() - t0
    db = LabelDatabase.load_or_create(root)
    pred = dict(zip(db.column("uuid"), db.column("predicted_label")))
    got32 = np.array([pred.get(u, np.nan) for u in listing])
    diff32 = float(np.abs(got32 - predicted["scores"]["float32"]).max())
    model = load_model(ckpt, "cuda")
    t0 = time.perf_counter()
    got16 = predict_sharded(model.params(), predicted["feats"], mesh, wire="float16",
                            class_values=model.meta.class_values)
    forward16 = time.perf_counter() - t0
    diff16 = float(np.abs(got16 - predicted["scores"]["float16"]).max())
    print(f"phase 39 sharded predict over {mesh}: {n} rows, float32 wire through the stage "
          f"in {wall:.2f} s (max |diff| against phase 17: {diff32:.3g}), float16 wire "
          f"predict_sharded {forward16:.3f} s (max |diff| {diff16:.3g})", flush=True)
    if not (n == len(listing) and diff32 <= 1e-6 and diff16 <= 2e-3):
        fail(f"phase 39: {n} rows, float32 diff {diff32}, float16 diff {diff16}")
    return {"phase": 39, "path": "sharded predict", "rows": n, "devices": DP_DEVICES,
            "float32_stage_s": wall, "float16_forward_s": forward16,
            "float32_max_abs_diff": diff32, "float16_max_abs_diff": diff16}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_ranks(args_of, env_extra: dict) -> list[str]:
    """Two processes (``args_of(rank)``: the command) with
    COORDINATOR_ADDRESS on localhost and the JAX package's
    JAX_NUM_PROCESSES/JAX_PROCESS_ID; each joined with a timeout, and a
    process still running then is killed (and the run fails). Returns their
    outputs."""
    port = _free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(args_of(rank), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=repo,
                              env=dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank),
                                       **env_extra))
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PARALLEL_TIMEOUT_S)
            outs.append(out)
            if p.returncode != 0:
                fail(f"phase 40: a process exited {p.returncode}: {out[-3000:]}")
    except subprocess.TimeoutExpired:
        fail("phase 40: a process ran past its timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def two_processes(root: str, l336: dict) -> dict:
    """Phase 40: two processes on the one card over gloo. Copies of the 32
    PNGs, byte-identical copies of two of them, and phase 5's .calib.npz:
    the embed CLI with --distributed in two processes (ViT-L-14-336
    int8_static, batch BATCH; COORDINATOR_ADDRESS on localhost, the rank
    from JAX_PROCESS_ID), each embedding its [rank::2] shard of the files;
    the store CLI's rebuild; the dedup CLI with --distributed --mode copy in
    two processes (a ring of two shards, one a process), each printing its
    pairs. Fails unless each process embeds its shard, every crop is within
    1 − cosine 1e-5 of one process embedding the same two host shards
    (``embed_dataset`` with ``host_index``/``host_count`` in turn, on a copy:
    the same batches) and within the int8_static budget, 2e-3, of phase 5's
    (a batch's canvas bucket follows its largest image, so other batches
    may resample a crop on another canvas), both processes report the pairs
    of a one-process run of the same store (the planted ones among them),
    and only rank 0 copied files."""
    from clip_assisted_data_labeling_tpu_torch.config import DedupConfig, EmbedConfig
    from clip_assisted_data_labeling_tpu_torch.pipeline.dedup import load_embeddings, run_dedup
    from clip_assisted_data_labeling_tpu_torch.pipeline.embed import embed_dataset

    base = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        t_phase = time.perf_counter()
        droot = os.path.join(base, "mydata")
        os.makedirs(droot)
        names = [os.path.basename(p)[:-3] + ".png" for p in l336["pts"]]
        for n in names:
            shutil.copy(os.path.join(root, n), droot)
        shutil.copy(os.path.join(root, "img_001.png"), os.path.join(droot, "zz_copy_a.png"))
        shutil.copy(os.path.join(root, "img_004.png"), os.path.join(droot, "zz_copy_b.png"))
        calib = MODEL.replace("/", "-") + ".calib.npz"
        shutil.copy(os.path.join(root, calib), droot)
        one_root = os.path.join(base, "one_process")
        shutil.copytree(droot, one_root)
        embed_args = ["-m", "clip_assisted_data_labeling_tpu_torch.pipeline.embed",
                      "--root_dir", droot, "--models_to_use", MODEL, "--compute_dtype",
                      "int8_static", "--batch_size", str(BATCH), "--num_workers", "4",
                      "--distributed"]
        t0 = time.perf_counter()
        outs = _spawn_ranks(lambda rank: [sys.executable, *embed_args], {})
        embed_s = time.perf_counter() - t0
        n_files = len(names) + 2
        for rank, out in enumerate(outs):
            shard = len(range(rank, n_files, 2))
            if f"Host shard {rank}/2: {shard} images" not in out:
                fail(f"phase 40: rank {rank} did not embed its shard: {out[-2000:]}")
        proc, rebuild_s = run_cli("clip_assisted_data_labeling_tpu_torch.pipeline.store",
                                  ["rebuild", "--root_dir", droot], "store")
        side = read_sides(droot, MODEL, names + ["zz_copy_a.png", "zz_copy_b.png"])
        for rank in range(2):
            embed_dataset(one_root, EmbedConfig(models_to_use=(MODEL,), batch_size=BATCH,
                                                num_workers=4, host_index=rank, host_count=2,
                                                device="cuda"))
        one_err = cos_err(side, read_sides(one_root, MODEL, names + ["zz_copy_a.png",
                                                                     "zz_copy_b.png"]))
        err = cos_err(side[:len(names)], l336["side"])
        diff = float(np.abs(side[:len(names)] - l336["side"]).max())
        code = ("import json, sys; from clip_assisted_data_labeling_tpu_torch.pipeline import "
                "dedup; r = dedup.main(sys.argv[1:]); print('PAIRS', json.dumps(r.pairs()))")
        t0 = time.perf_counter()
        outs = _spawn_ranks(lambda rank: [sys.executable, "-c", code, "--root_dir", droot,
                                          "--threshold", "0.99", "--mode", "copy",
                                          "--distributed"], {})
        dedup_s = time.perf_counter() - t0
        reported = []
        for out in outs:
            lines = [ln for ln in out.splitlines() if ln.startswith("PAIRS ")]
            if not lines:
                fail(f"phase 40: a dedup process printed no pairs: {out[-2000:]}")
            reported.append(sorted((i, j) for i, j, _m in json.loads(lines[-1][6:])))
        one = sorted((i, j) for i, j, _m in run_dedup(
            droot, DedupConfig(threshold=0.99, test=True), device="cuda").pairs())
        paths, _emb = load_embeddings(droot, DedupConfig())
        stem = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        found = {frozenset((stem[i], stem[j])) for i, j in one}
        planted = {frozenset(("img_001", "zz_copy_a")), frozenset(("img_004", "zz_copy_b"))}
        outdir = os.path.join(base, "near_duplicates_cosine_0.99")
        copied = len(os.listdir(outdir)) if os.path.isdir(outdir) else 0
        copiers = sum("copying" in out for out in outs)
        print(f"phase 40 two processes on one card (gloo): embed --distributed {embed_s:.1f} s, "
              f"store rebuild {rebuild_s:.1f} s, dedup --distributed {dedup_s:.1f} s; crops "
              f"against one process's host shards: 1 - cosine max {one_err:.3g}; against "
              f"phase 5: 1 - cosine max {err:.3g}, max abs {diff:.3g}; pairs "
              f"{reported[0]} on rank 0, {reported[1]} on rank 1, {one} in one process; "
              f"{copied} files copied by {copiers} process; phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        if not (reported[0] == reported[1] == one and planted <= found and one_err <= 1e-5
                and err <= 2e-3 and copiers == 1 and "copying" in outs[0]
                and copied == 4 * len(one)):
            fail(f"phase 40: pairs {reported} against {one}, planted found "
                 f"{planted <= found}, 1 - cosine {one_err} (one process), {err} (phase 5), "
                 f"{copied} files by {copiers} processes")
        return {"phase": 40, "path": "two processes, gloo", "processes": 2,
                "embed_s": embed_s, "rebuild_s": rebuild_s, "dedup_s": dedup_s,
                "cos_err_one_process": one_err, "cos_err_phase5": err,
                "max_abs_diff_phase5": diff, "pairs": len(one)}
    finally:
        shutil.rmtree(base, ignore_errors=True)


# --- phases 41-44: the tools and the dry run ------------------------------------------
TOOLS_PKG = "clip_assisted_data_labeling_tpu_torch.tools."
MERGE_N = 4096  # rows of each merged dataset
SUBSET_STEMS, SUBSET_FRACTION = 8192, 0.25
SEARCH_N, CONTEXT_N, PLANTED_N = PREDICT_N, 40, 30  # phase 17's N; the tools' default top_n
SVM_SUBSET = 16384  # rows of the card-against-CPU solve
SEARCH_CROP = "square_padded_crop"  # the search tools' default crop
LATENT_N, LATENT_SEQ = 1024, 77  # prompts of [2, 77, 768] c/uc latents
DRYRUN_LAYERS = 2  # every tiny tower of the dry run


def merge_cli(base: str) -> dict:
    """Phase 41a: the merge_datasets CLI on two datasets of MERGE_N rows
    (the odd rows labelled, integer timestamps, one uuid in both datasets'
    labelled halves), each row a .jpg: the labelled and unlabelled CSVs
    byte for byte as pandas writes them (written here from the same rows),
    every file moved, the clash kept under its ``<subdir>_`` prefix."""
    data, out = os.path.join(base, "merge", "data"), os.path.join(base, "merge", "out")
    rng = np.random.default_rng(41)
    clash = "c1a5" * 8
    want = {"labeled": [], "unlabeled": []}
    for k, name in enumerate(("set_a", "set_b")):
        os.makedirs(os.path.join(data, name))
        lines = ["uuid,label,timestamp,predicted_label"]
        labels = rng.integers(0, 10, MERGE_N)
        preds = np.round(rng.uniform(0, 9, MERGE_N), 4)
        for i in range(MERGE_N):
            u = clash if i == 1 else f"{k:02x}{i:030x}"
            label = repr(float(labels[i])) if i % 2 else ""
            row = f"{u},{label},{1700000000 + i},{preds[i]!r}"
            lines.append(row)
            want["labeled" if i % 2 else "unlabeled"].append(f"{row},{name}")
            with open(os.path.join(data, name, u + ".jpg"), "wb") as f:
                f.write(u.encode())
        with open(os.path.join(data, f"{name}.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    proc, wall = run_cli(TOOLS_PKG + "merge_datasets", ["--data_dir", data, "--output_dir", out],
                         "merge_datasets")
    header = "uuid,label,timestamp,predicted_label,source_datadir"
    same = {}
    for split, rows in want.items():
        with open(os.path.join(out, f"{split}.csv")) as f:
            same[split] = f.read() == "\n".join([header, *rows]) + "\n"
    moved = {split: sorted(os.listdir(os.path.join(out, split))) for split in want}
    left = sum(len(os.listdir(os.path.join(data, n))) for n in ("set_a", "set_b"))
    ok = (all(same.values()) and len(moved["labeled"]) == len(moved["unlabeled"]) == MERGE_N
          and f"set_b_{clash}.jpg" in moved["labeled"] and left == 0
          and "WARNING: 1 files shared a uuid" in proc.stdout)
    print(f"phase 41 merge_datasets CLI: 2 x {MERGE_N} rows in {wall:.2f} s; CSVs as pandas "
          f"writes them {same}; moved {len(moved['labeled'])} + {len(moved['unlabeled'])} "
          f"files, {left} left, the clash kept as set_b_{clash}.jpg: "
          f"{f'set_b_{clash}.jpg' in moved['labeled']}", flush=True)
    if not ok:
        fail(f"phase 41 merge_datasets: {same}, {left} files left, {proc.stdout[-800:]}")
    return {"phase": 41, "tool": "merge_datasets", "rows": 2 * MERGE_N, "seconds": wall}


def subset_tool_cli(base: str) -> dict:
    """Phase 41b: the move_subset_of_files CLI over SUBSET_STEMS stems x 2
    extensions in two subdirectories at --fraction_f 0.25 --seed 0: the
    copied tree exactly the stems of ``random.Random(0)``'s draw, one per
    stem in the walk's order, each with both files."""
    import random

    root, out = os.path.join(base, "subset", "root"), os.path.join(base, "subset", "out")
    for i in range(SUBSET_STEMS):
        sub = os.path.join(root, "a" if i % 2 else "b")
        os.makedirs(sub, exist_ok=True)
        for ext in (".jpg", ".txt"):
            with open(os.path.join(sub, f"s{i:05d}{ext}"), "wb") as f:
                f.write(f"{i}{ext}".encode())
    order = [(os.path.relpath(d, root), os.path.splitext(n)[0])
             for d, _subs, names in os.walk(root) for n in names]
    stems = list(dict.fromkeys(s for _d, s in order))
    where = {s: d for d, s in order}
    draw = random.Random(0)
    chosen = [s for s in stems if draw.random() < SUBSET_FRACTION]
    proc, wall = run_cli(TOOLS_PKG + "move_subset_of_files",
                         ["--root_dir", root, "--out_dir", out, "--fraction_f",
                          str(SUBSET_FRACTION), "--seed", "0", "--file_extensions", ".jpg",
                          ".txt"], "move_subset_of_files")
    got = {os.path.relpath(os.path.join(d, n), out) for d, _s, names in os.walk(out)
           for n in names}
    want = {os.path.join(where[s], s + ext) for s in chosen for ext in (".jpg", ".txt")}
    line = f"Sampled {len(chosen)}/{SUBSET_STEMS} stems (target fraction 0.25) into {out}"
    print(f"phase 41 move_subset_of_files CLI: {len(chosen)} of {SUBSET_STEMS} stems in "
          f"{wall:.2f} s; the tree is random.Random(0)'s draw: {got == want}", flush=True)
    if got != want or line not in proc.stdout:
        fail(f"phase 41 move_subset_of_files: {len(got)} files against {len(want)}; "
             f"{proc.stdout[-500:]}")
    return {"phase": 41, "tool": "move_subset_of_files", "stems": SUBSET_STEMS,
            "chosen": len(chosen), "seconds": wall}


def quarantine_cli(base: str, png_dir: str) -> dict:
    """Phase 41c: the fix_img_dir CLI on phase 4's 32 PNGs and planted
    files: a valid gray JPEG, a PNG named .jpg and a JPEG cut inside its
    scan data (readable, as under PIL), a zero-byte file, junk, a PNG with
    a flipped IDAT byte (broken CRC) and a JPEG cut after its SOF (all
    quarantined). Where PIL is installed the tool asks it and the port's
    own check (``verify_image``) is held to the same verdicts in process."""
    from clip_assisted_data_labeling_tpu_torch.data.imsize import gray_jpeg_bytes
    from clip_assisted_data_labeling_tpu_torch.tools.fix_img_dir import verify_image

    src = os.path.join(base, "quarantine", "imgs")
    os.makedirs(src)
    pngs = sorted(glob.glob(os.path.join(png_dir, "img_*.png")))
    for p in pngs:
        shutil.copy(p, src)
    with open(pngs[0], "rb") as f:
        png = bytearray(f.read())
    png[len(png) // 2] ^= 0xFF
    jpg = gray_jpeg_bytes(64, 48)
    sof = jpg.index(b"\xff\xc0")
    sos = jpg.index(b"\xff\xda")
    planted = {"gray.jpg": jpg, "png_named.jpg": open(pngs[1], "rb").read(),
               "cut_in_scan.jpg": jpg[:sos + 2 + 8 + 4], "zero.png": b"",
               "junk.jpg": np.random.default_rng(41).bytes(256), "bad_crc.png": bytes(png),
               "cut_after_sof.jpg": jpg[:sof + 2 + struct.unpack(">H", jpg[sof + 2:sof + 4])[0]]}
    for name, data in planted.items():
        with open(os.path.join(src, name), "wb") as f:
            f.write(data)
    want = ["bad_crc.png", "cut_after_sof.jpg", "junk.jpg", "zero.png"]
    proc, wall = run_cli(TOOLS_PKG + "fix_img_dir", ["--src_folder", src], "fix_img_dir")
    errored = src + "_errored"
    got = sorted(os.listdir(errored))
    with_pil = "PIL" in cli_imports(proc)
    own = []
    for d in (src, errored):
        for name in sorted(os.listdir(d)):
            try:
                verify_image(os.path.join(d, name))
            except (OSError, ValueError):
                own.append(name)
    print(f"phase 41 fix_img_dir CLI ({'PIL' if with_pil else 'the port’s own check'}): "
          f"{len(pngs) + len(planted)} files in {wall:.2f} s, quarantined {got}; the port's "
          f"own check quarantines {sorted(own)}", flush=True)
    if got != want or sorted(own) != want or len(os.listdir(src)) != len(pngs) + 3:
        fail(f"phase 41 fix_img_dir: quarantined {got}, own check {own}, want {want}")
    return {"phase": 41, "tool": "fix_img_dir", "files": len(pngs) + len(planted),
            "quarantined": len(got), "verdict_by": "PIL" if with_pil else "port",
            "seconds": wall}


def investigate_cli(sidecar: str) -> dict:
    """Phase 41d: the investigate_embedding CLI on a phase-5 sidecar: one
    block a model, each crop's shape and dtype and each image stat's value."""
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import read_sidecar

    want = []
    for model, feats in read_sidecar(sidecar).items():
        want.append(f"{model}:")
        for k, v in feats.items():
            want.append(f"  {k}: " + (f"scalar {float(v):.6f}" if np.ndim(v) == 0 else
                                       f"array shape={tuple(v.shape)} dtype={v.dtype}"))
    proc, wall = run_cli(TOOLS_PKG + "investigate_embedding", [sidecar], "investigate_embedding")
    got = proc.stdout.splitlines()
    print(f"phase 41 investigate_embedding CLI: {len(got)} lines in {wall:.2f} s, as "
          f"expected: {got == want}; {got[:2]}", flush=True)
    if got != want or f"{MODEL}:" not in got:
        fail(f"phase 41 investigate_embedding printed {got[:8]}")
    return {"phase": 41, "tool": "investigate_embedding", "lines": len(got), "seconds": wall}


def host_tools(png_dir: str, sidecar: str) -> list[dict]:
    """Phase 41: the four host tools through their CLIs, each in a process
    of its own (no pandas, scikit-learn, JAX or the JAX package imported)."""
    base = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        return [merge_cli(base), subset_tool_cli(base), quarantine_cli(base, png_dir),
                investigate_cli(sidecar)]
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _near(u: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """n unit rows of 4 crops near the unit vector u (noise of norm ~0.3)."""
    x = u + 0.3 * torch.randn((n, 4, u.numel()), generator=gen, device="cuda") / math.sqrt(
        u.numel())
    return x / x.norm(dim=-1, keepdim=True)


def search_at_scale(phase17_root: str | None) -> dict:
    """Phase 42: find_similar_imgs (cosine and l2) and svm_similarity through
    their CLIs on the card at a user's scale. The search set: phase 17's
    directory where it still exists (its float16 ViT-L-14-336 store of
    PREDICT_N rows x 4 crops x 768 and a gray JPEG a row), else a store of
    SEARCH_N rows from ``write_feature_store`` with an empty .jpg beside each
    row (the tools check and copy, and decode nothing); PLANTED_N of its rows
    replaced by rows near a planted direction; the context: CONTEXT_N
    sidecars near the same direction (the context's collection takes the
    sidecar walk, the search set's the store). Each run's top PLANTED_N
    must be the planted rows; every distance within 1e-6 of a float64
    recomputation on the card; the SVM's final gradient norm within 1e-8 of
    its first, and its margins on a SVM_SUBSET-row subset within 1e-6 of the
    same solver in float64 on the CPU. Seconds by collection, device and
    copies."""
    from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
    from clip_assisted_data_labeling_tpu_torch.store.columnar import EmbeddingStore
    from clip_assisted_data_labeling_tpu_torch.store.sidecar import write_sidecar
    from clip_assisted_data_labeling_tpu_torch.tools import find_similar_imgs as fsi
    from clip_assisted_data_labeling_tpu_torch.tools import svm_similarity as svm

    base = tempfile.mkdtemp(prefix="chip_smoke_search_")
    try:
        t0 = time.perf_counter()
        ctx = os.path.join(base, "context")
        if phase17_root and EmbeddingStore.exists(phase17_root, MODEL):
            search = phase17_root
        else:
            search = os.path.join(base, "search")
            os.makedirs(search)
            write_feature_store(search, SEARCH_N, 42)
            for name in EmbeddingStore.open(search, MODEL).uuids:
                open(os.path.join(search, name + ".jpg"), "wb").close()
        uuids = EmbeddingStore.open(search, MODEL).uuids
        n_rows = len(uuids)
        gen = torch.Generator(device="cuda").manual_seed(42)
        u = torch.randn(STAGE_D, generator=gen, device="cuda")
        u = u / u.norm()
        planted = np.sort(np.random.default_rng(42).choice(n_rows, PLANTED_N, replace=False))
        store = EmbeddingStore.open(search, MODEL, mode="r+")
        store.embeddings[planted] = _near(u, PLANTED_N, gen).half().cpu().numpy()
        store.flush()
        del store
        os.makedirs(ctx)  # a context dir holds .pt sidecars (one without is a dir of contexts)
        for i, row in enumerate(_near(u, CONTEXT_N, gen).cpu().numpy()):
            write_sidecar(os.path.join(ctx, f"ctx{i:029x}.pt"), MODEL, dict(zip(ALL_CROPS, row)))
        setup_s = time.perf_counter() - t0
        want = {uuids[i] for i in planted}

        def top(results) -> set:
            return {os.path.basename(p)[:-4] for _score, p in results}

        records = []
        _names, _paths, ctx_emb = fsi._collect_embeddings(ctx, ["all"], SEARCH_CROP)
        _names, _paths, emb = fsi._collect_embeddings(search, ["all"], SEARCH_CROP)
        c64 = torch.from_numpy(ctx_emb).cuda().double().mean(dim=0)
        e64 = torch.from_numpy(emb).cuda().double()
        exact = {"cosine": ((1 - (e64 / e64.norm(dim=1, keepdim=True)) @ (c64 / c64.norm()))
                            / 2).cpu().numpy(),
                 "l2": torch.sqrt(((e64 - c64) ** 2).sum(dim=1) + 1e-12).cpu().numpy()}
        del e64
        for measure in ("cosine", "l2"):
            out = os.path.join(base, f"similar_{measure}")
            seconds: list = []
            runs = fsi.main(["--context_dir", ctx, "--search_dir", search, "--output_dir", out,
                             "--similarity_measure", measure, "--top_n", str(PLANTED_N),
                             "--device", "cuda"], timings=seconds)
            got = top(runs[0])
            dists = fsi.compute_distances(ctx_emb.mean(axis=0), emb, measure, "cuda")
            err = float(np.abs(dists - exact[measure]).max())
            rows = {u_: i for i, u_ in enumerate(uuids)}
            cli_err = max(abs(d - exact[measure][rows[os.path.basename(p)[:-4]]])
                          for d, p in runs[0])
            rec = {"phase": 42, "tool": "find_similar_imgs", "measure": measure,
                   "rows": n_rows, **seconds[0], "max_abs_err_vs_float64": err,
                   "top_is_planted": got == want}
            records.append(rec)
            print(f"phase 42 find_similar_imgs {measure}: {n_rows} rows; collect "
                  f"{rec['collect_s']:.2f} s, device {rec['device_s']:.3f} s, copies "
                  f"{rec['copy_s']:.3f} s; top {PLANTED_N} the planted rows: {got == want}; "
                  f"distances against float64 on the card: max {err:.3g} (the CLI's "
                  f"{cli_err:.3g}); {len(os.listdir(out))} files copied", flush=True)
            if not (got == want and err <= 1e-6 and cli_err <= 1e-6
                    and len(os.listdir(out)) == PLANTED_N):
                fail(f"phase 42 {measure}: top planted {got == want}, distance error {err} "
                     f"(CLI {cli_err}), {len(os.listdir(out))} copies")
        seconds = {}
        results = svm.main(["--context_dir", ctx, "--search_dir", search, "--output_dir",
                            os.path.join(base, "svm"), "--top_n", str(PLANTED_N),
                            "--device", "cuda"], timings=seconds)
        got = top(results)
        rel = seconds["grad_norm"] / seconds["grad_norm_0"]
        sub = emb[:SVM_SUBSET]
        t1 = time.perf_counter()
        card = svm.svm_rank(ctx_emb, sub, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cpu = svm.svm_rank(ctx_emb, sub, device="cpu")
        cpu_s = time.perf_counter() - t1
        sub_err = float(np.abs(card - cpu).max())
        rec = {"phase": 42, "tool": "svm_similarity", "rows": n_rows,
               "collect_s": seconds["collect_s"], "device_s": seconds["device_s"],
               "copy_s": seconds["copy_s"], "newton_steps": seconds["steps"],
               "grad_norm_rel": rel, "top_is_planted": got == want,
               "subset_rows": SVM_SUBSET, "subset_card_s": card_s, "subset_cpu_s": cpu_s,
               "subset_max_abs_err_vs_cpu": sub_err, "setup_s": setup_s,
               "search_set": "phase 17's" if search == phase17_root else "its own"}
        records.append(rec)
        print(f"phase 42 svm_similarity: {n_rows} + {CONTEXT_N} rows x {STAGE_D + 1}; "
              f"collect {rec['collect_s']:.2f} s, device (fit and scores, float64) "
              f"{rec['device_s']:.3f} s in {seconds['steps']} Newton steps, copies "
              f"{rec['copy_s']:.3f} s; gradient norm {rel:.3g} of its first; top "
              f"{PLANTED_N} the planted rows: {got == want}; {SVM_SUBSET} rows: card "
              f"{card_s:.2f} s, CPU {cpu_s:.2f} s, margins within {sub_err:.3g}; set-up "
              f"{setup_s:.1f} s", flush=True)
        if not (got == want and rel <= 1e-8 and sub_err <= 1e-6):
            fail(f"phase 42 svm: top planted {got == want}, gradient {rel}, CPU diff {sub_err}")
        return {"records": records}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def latent_regressor_on_card() -> dict:
    """Phase 43: the train_latent_regressor CLI on the card in its default
    configuration (hidden 264, 128, 64; 40 epochs). LATENT_N prompts of
    [2, 77, 768] float32 ``.pth`` latents (c: a shared mean, a latent z along
    a seeded direction, noise; uc: one shared tensor), labelled 0-9 from z,
    a quarter of the rows carrying only a predicted_label (their target is
    half of it, the tool's pseudo-label). The final test MSE must be under
    half the dummy baseline's and the checkpoint must load with the port's
    regressor and give the trained model's scores."""
    from clip_assisted_data_labeling_tpu_torch.models.regressor import SimpleFCRegressor
    from clip_assisted_data_labeling_tpu_torch.store.database import LabelDatabase
    from clip_assisted_data_labeling_tpu_torch.tools import train_latent_regressor as tlat

    base = tempfile.mkdtemp(prefix="chip_smoke_latents_")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(43)
        uc = rng.standard_normal((LATENT_SEQ, STAGE_D), dtype=np.float32)
        mean_c = rng.standard_normal((LATENT_SEQ, STAGE_D), dtype=np.float32)
        direction = rng.standard_normal((LATENT_SEQ, STAGE_D), dtype=np.float32)
        z = rng.standard_normal(LATENT_N)
        labels = np.clip(np.round(4.5 + 2.0 * z + rng.normal(0, 0.5, LATENT_N)), 0, 9)
        pseudo = np.zeros(LATENT_N, bool)
        pseudo[rng.permutation(LATENT_N)[: LATENT_N // 4]] = True
        uuids = [f"{i:032x}" for i in range(LATENT_N)]
        os.makedirs(os.path.join(base, "data", "prompts"))
        for i, u in enumerate(uuids):
            c = (mean_c + np.float32(0.5 * z[i]) * direction
                 + 0.5 * rng.standard_normal((LATENT_SEQ, STAGE_D), dtype=np.float32))
            torch.save(torch.from_numpy(np.stack([c, uc])),
                       os.path.join(base, "data", "prompts", f"{u}.pth"))
        LabelDatabase({"uuid": uuids, "label": np.where(pseudo, np.nan, labels),
                       "timestamp": np.full(LATENT_N, 1.7e9),
                       "predicted_label": np.where(pseudo, 4.5 + 2.0 * z, np.nan)},
                      os.path.join(base, "data", "prompts.csv")).save()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.chdir(base):
            model, history, path = tlat.main(["--train_data_dir", os.path.join(base, "data"),
                                              "--train_data_names", "prompts",
                                              "--device", "cuda"])
        wall = time.perf_counter() - t0
        mse, dummy = history["test"][-1], history["third"][-1]
        loaded = SimpleFCRegressor.load(os.path.join(base, path), "cuda")
        feats = np.stack([torch.load(os.path.join(base, "data", "prompts", f"{u}.pth"))
                          .numpy().reshape(-1) for u in uuids[:64]])
        load_err = float(np.abs(loaded.predict(feats, wire="float32")
                                - model.predict(feats, wire="float32")).max())
        rec = {"phase": 43, "tool": "train_latent_regressor", "prompts": LATENT_N,
               "features": 2 * LATENT_SEQ * STAGE_D, "epochs": 40, "steps": history["steps"],
               "train_s": history["seconds"], "steps_per_s": history["steps"] / history["seconds"],
               "cli_s": wall, "setup_s": setup_s, "test_mse": mse, "dummy_mse": dummy,
               "checkpoint_score_err": load_err}
        print(f"phase 43 train_latent_regressor CLI: {LATENT_N} prompts x "
              f"{rec['features']} features, {history['steps']} steps in "
              f"{history['seconds']:.2f} s = {rec['steps_per_s']:.0f} steps/s ({wall:.2f} s "
              f"with loading and saving; data {setup_s:.1f} s); test MSE {mse:.4f} against the "
              f"dummy baseline's {dummy:.4f}; the checkpoint's scores within {load_err:.3g}",
              flush=True)
        if not (mse < 0.5 * dummy and load_err <= 1e-6
                and loaded.meta.input_size == rec["features"]):
            fail(f"phase 43: test MSE {mse} against dummy {dummy}, checkpoint {load_err}")
        return rec
    finally:
        shutil.rmtree(base, ignore_errors=True)


def dryrun_launches(n: int) -> dict:
    """The dry run's kernel launches on n devices (every tiny tower
    DRYRUN_LAYERS deep): K1 once a layer in each one-device reference
    forward and in each shard forward — data-parallel: n shards; 2-D (n/2
    data rows x 2 model shards): one a (row, shard) pair — for the bf16
    embed, ViT-Test/tiny's and EVA-Test-Wide's int8_static TP and the
    post-norm tower's data parallelism; K2 only in EVA-Test-Wide's lnk
    blocks, three times a layer (ln1, the attention sub-LN, ln2) in the
    one-device forward and in each data row of the TP forward."""
    L = DRYRUN_LAYERS
    if n >= 4 and n % 2 == 0:
        tp = 1 + n  # the one-device forward and the (n/2) x 2 shard forwards
        return {"K1": L * (3 * tp + 1 + n), "K2": 3 * L * (1 + n // 2)}
    return {"K1": 2 * L * (1 + n)}


def dryrun_on_card() -> tuple[dict, dict]:
    """Phase 44: ``dryrun_multichip(4)`` (the 2-D branch) and
    ``dryrun_multichip(2)`` (1-D) on the card listed n times, each check
    passing and the launches exactly :func:`dryrun_launches`; then
    ``entry()``'s flagship step once at full width (ViT-L-14 bf16, 2 canvases
    x 4 crops: K1 24 times), finite unit embeddings, timed."""
    from clip_assisted_data_labeling_tpu_torch import dryrun

    record, paths = {"phase": 44}, {}
    for n in (4, 2):
        reset_counts()
        t0 = time.perf_counter()
        figures = dryrun.dryrun_multichip(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        want = {k: dryrun_launches(n).get(k, 0) for k in got}
        paths[f"dryrun{n}"] = got
        record[f"dryrun_{n}"] = {"seconds": wall, "launches": got, **figures}
        print(f"phase 44 dryrun_multichip({n}) on the repeated card: {wall:.2f} s; launches "
              f"{got} (want {want})", flush=True)
        if got != want:
            fail(f"phase 44 dryrun({n}): launches {got}, expected {want}")
    step, args = dryrun.entry("cuda")
    model, canvases, crop_params = args
    same_args = all(np.array_equal(a, b) for a, b in zip((canvases, crop_params),
                                                         dryrun.example_args()))
    reset_counts()
    emb = step(*args)
    torch.cuda.synchronize()
    got = counts()
    paths["entry"] = got
    want = {k: (model.cfg.layers if k == "K1" else 0) for k in got}
    norms = emb.norm(dim=-1)
    ms = time_ms(lambda: step(*args), min_reps=3, min_s=0.3)
    record["entry"] = {"model": dryrun.FLAGSHIP, "shape": list(emb.shape), "launches": got,
                       "ms": ms, "max_norm_err": float((norms - 1).abs().max())}
    print(f"phase 44 entry(): {dryrun.FLAGSHIP} bf16 step on {tuple(canvases.shape)} canvases "
          f"-> {tuple(emb.shape)} in {ms:.2f} ms a step; launches {got} (want {want}); "
          f"|norm - 1| max {record['entry']['max_norm_err']:.2e}", flush=True)
    if not (got == want and same_args and torch.isfinite(emb).all()
            and tuple(emb.shape) == (2, 4, model.cfg.embed_dim)
            and record["entry"]["max_norm_err"] < 1e-3):
        fail(f"phase 44 entry: launches {got}, args {same_args}, shape {tuple(emb.shape)}")
    del model, args, emb
    torch.cuda.empty_cache()
    return record, paths


def check_dryrun_kernels(xgen: torch.Generator) -> list[dict]:
    """Phase 3, the shapes of phase 44 (inputs from ``xgen``): K1 bf16 at
    entry()'s [8, 257, 3072] (ViT-L-14, 16 heads); at the 2-D dry run's
    shards of ViT-Test/tiny ([16, 17, 96], 2 heads of 16: the bf16 embed,
    and in float32 the int8_static TP) and of EVA-Test-Wide with RoPE ([2,
    17, 192], 2 heads of 32); K2 at EVA-Test-Wide's TP data row [34, 128];
    K1 bf16 at the 1-D dry run's shard [8, 17, 192] (4 heads)."""
    import dataclasses

    from clip_assisted_data_labeling_tpu_torch.models.vit import resolve_config

    bf16 = (torch.bfloat16, 2e-2, H100_BF16_FLOPS, None)
    f32tc = (torch.float32, 1e-5, H100_3XTF32_FLOPS, H100_F32_FLOPS)
    tiny, eva = resolve_config("ViT-Test/tiny"), resolve_config("EVA-Test-Wide/tiny")
    tiny_half = dataclasses.replace(tiny, width=tiny.width // 2, heads=tiny.heads // 2)
    eva_half = dataclasses.replace(eva, width=eva.width // 2, heads=eva.heads // 2)
    rows = [attention_case("K1", resolve_config(L14), 8, bf16, False, ("entry", "K1"), xgen),
            attention_case("K1", tiny_half, 16, bf16, False, ("dryrun4", "K1"), xgen),
            attention_case("K1", tiny_half, 16, f32tc, False, ("dryrun4", "K1"), xgen),
            attention_case("K1", eva_half, 2, bf16, True, ("dryrun4", "K1"), xgen),
            attention_case("K1", tiny, 8, bf16, False, ("dryrun2", "K1"), xgen)]
    g = 1 + 0.1 * torch.randn((eva.width,), generator=xgen, device="cuda")
    bta = 0.1 * torch.randn((eva.width,), generator=xgen, device="cuda")
    rows.append(rowquant_static_case(2 * eva.seq_len, eva.width, g, bta,
                                     torch.tensor([6.0], device="cuda"), ("dryrun4", "K2"),
                                     xgen))
    for r in rows:
        if not (r["max_abs_err"] <= r["tol"]):
            fail(f"{r['name']} {r['case']} disagrees with its plain version: {r['max_abs_err']}")
    return rows


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


def check_no_jax() -> None:
    if any(m == "jax" or m.startswith(("jax.", "clip_assisted_data_labeling_tpu."))
           or m == "clip_assisted_data_labeling_tpu" for m in sys.modules):
        fail("JAX or the JAX package was imported")


def elapsed(t_start: float, phases: str) -> None:
    """The script's seconds so far, as the named phases start (the whole run
    has a time limit; these lines say which phases spend it)."""
    print(f"[{time.perf_counter() - t_start:.1f} s] phases {phases}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
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
    check_no_jax()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; image decoder: {decoder_name()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    elapsed(t_start, "2")
    # --- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _cuda_build.build_all()
    for name, log in logs.items():
        print(f"built {name}:")
        for line in ptxas_summary(log):
            print(f"  {line}")
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    elapsed(t_start, "3")
    # --- phase 3: kernels against their plain versions ----------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_kernels(gen, *(torch.Generator(device="cuda").manual_seed(i)
                                for i in (1, 2, 3, 4, 5, 6, 7)))
    rows += check_tower_kernels(torch.Generator(device="cuda").manual_seed(8))
    rows += check_parallel_kernels(torch.Generator(device="cuda").manual_seed(9))
    rows += check_dryrun_kernels(torch.Generator(device="cuda").manual_seed(10))
    quant_out_long_sequences()
    torch.cuda.empty_cache()

    cfg, scfg = resolve_config(MODEL), resolve_config(SIGLIP)
    pcfg, gcfg = resolve_config(PE_L), resolve_config(PE_G)
    with (tempfile.TemporaryDirectory(prefix="chip_smoke_") as root,
          tempfile.TemporaryDirectory(prefix="chip_smoke_stages_") as stages_base):
        write_pngs(root)

        elapsed(t_start, "5-6")
        # --- phases 5-6: ViT-L-14-336 int8_static: K1 once and K2 twice a
        # layer; the calibration forward runs the XLA-style attention, no kernel
        l336 = embed_and_check(root, MODEL, cfg, {"K1": cfg.layers, "K2": 2 * cfg.layers})
        elapsed(t_start, "7")
        # --- phase 7: float32 paths on a few images: L-336 takes K4 (the JAX
        # package's grouped route for its shape), L-14 at 224 px K1
        l336_f32 = encoder_run(MODEL, "float32", l336["pts"], l336["side"], cfg,
                               {"K4": cfg.layers}, timed=True)
        l14cfg = resolve_config(L14)
        l14_f32 = encoder_run(L14, "float32", l336["pts"], None, l14cfg, {"K1": l14cfg.layers},
                              timed=True, cpu_ref=True)

        elapsed(t_start, "7a-7b")
        # --- phases 7a-7b: ViT-L-14-336 dynamic int8 in every block route
        dyn, dyn_routes = dynamic_int8(root, cfg, l336)

        elapsed(t_start, "8-9")
        # --- phases 8-9: ViT-SO400M-14-SigLIP-384 int8_static through the int8
        # attention wire (K3 a layer), then bfloat16 (K5 a layer)
        so400m = embed_and_check(root, SIGLIP, scfg, {"K3": scfg.layers})
        bf16 = encoder_run(SIGLIP, "bfloat16", so400m["pts"], so400m["side"], scfg,
                           {"K5": scfg.layers}, timed=True)
        elapsed(t_start, "9a")
        # --- phase 9a: its float32 path (K5's float32 kernel a layer), held
        # against the same encoder on the CPU on one image
        so400m_f32 = encoder_run(SIGLIP, "float32", so400m["pts"], so400m["side"], scfg,
                                 {"K5": scfg.layers}, timed=True, cpu_ref=True, cpu_images=1)

        elapsed(t_start, "10-11")
        # --- phases 10-11: PE-Core-L14-336 int8_static (K1 with RoPE once and
        # K2 twice a layer), then its bf16 (K1) and float32 (K4) paths
        pe = embed_and_check(root, PE_L, pcfg, {"K1": pcfg.layers, "K2": 2 * pcfg.layers})
        pe_bf16 = encoder_run(PE_L, "bfloat16", pe["pts"], pe["side"], pcfg,
                              {"K1": pcfg.layers}, timed=True)
        pe_f32 = encoder_run(PE_L, "float32", pe["pts"], pe["side"], pcfg, {"K4": pcfg.layers},
                             timed=True)
        elapsed(t_start, "12")
        # --- phase 12: PE-Core-G14-448 bf16, all 50 layers (K4 with RoPE)
        g14 = encoder_run(PE_G, "bfloat16", pe["pts"], None, gcfg, {"K4": gcfg.layers},
                          timed=True)

        elapsed(t_start, "13")
        # --- phase 13: the int8_static routes of CTPU_LN_KERNEL and CTPU_INT8_WIRE
        routes = knob_routes(l336, so400m, cfg, scfg)

        elapsed(t_start, "24-31")
        # --- phases 24-31: the rest of stage 1 on the ViT trunk: EVA02-L-336
        # int8_static through the CLI, EVA02-L f32 against the CPU, G14
        # int8_static, the CLIPA, EVA01, CoCa and EVA02-E towers, naflex with
        # --aspect native, dynamic int8 hybrid on SO400M and PE-L14, the embed
        # flags, the native decoder
        tower_paths = towers(root, l336)
        tower_paths["naflex"] = naflex_native(root)
        tower_paths.update(dynamic_int8_more(so400m, pe, scfg, pcfg))
        tower_paths["flags"] = embed_flags(root)
        decoder = native_decoder()

        elapsed(t_start, "32-34")
        # --- phases 32-34: the modified ResNets and ConvNeXt (cuDNN convolutions
        # and torch products, as the JAX package runs XLA's: no kernel of the table)
        conv_records, conv_paths = conv_towers(root)
        tower_paths.update(conv_paths)

        elapsed(t_start, "14-15")
        # --- phases 14-15: stage 2 (no kernel of the table: torch products)
        # at N = 262144, then the dedup CLI end to end on embedded PNGs
        dedup_records, phase14 = dedup_at_scale()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dedup_") as dedup_base:
            dedup_embed, phase15_rows = dedup_cli(root, dedup_base)

            elapsed(t_start, "16-19")
            # --- phases 16-19: stages 4-6 (train, predict, the single-image
            # scorer: K1 through its bf16 encoder, subset) on a dataset of
            # their own, then phase 39: predict over a mesh on phase 17's rows
            stage_records, scorer, phase39, phase17_root = stages(root, phase15_rows,
                                                                  stages_base)

            elapsed(t_start, "20-23")
            # --- phases 20-23: prep, the store CLI on phase 15's sidecars, the
            # diversity order at scale and the loop (torch products, no kernel)
            loop_records = [prep_cli(root), store_rebuild(os.path.join(dedup_base, "mydata"))]
        loop_records += diversity_at_scale()
        loop_records.append(loop_cli())

        elapsed(t_start, "36-40")
        # --- phases 36-40: the parallel layer on the one card (a repeated
        # device makes the mesh): data-parallel embed, tensor parallel, the
        # ring dedup (phase 38, at phase 14's N), then two processes over gloo
        dp = dp_embed(root, l336)
        tp_paths, tp_records = tensor_parallel(root, l336["pts"])
        ring_records = ring_dedup(phase14)
        del phase14
        mp = two_processes(root, l336)
        parallel_records = [dp["record"], *tp_records, *ring_records, phase39, mp]

        elapsed(t_start, "41-44")
        # --- phases 41-44: the tools (the host tools in processes of their own,
        # the device tools on the card: torch products and a float64 solve, no
        # kernel of the table) and the dry run with entry() (K1, K2)
        tool_records = host_tools(root, l336["pts"][0])
        elapsed(t_start, "42")
        tool_records += search_at_scale(phase17_root)["records"]
        elapsed(t_start, "43")
        tool_records.append(latent_regressor_on_card())
        elapsed(t_start, "44")
        dry, dry_paths = dryrun_on_card()
    elapsed(t_start, "done")

    # each row's launches: the counter its ``path`` names, read from that
    # main path; "all" (the kernels no path of the JAX package reaches) sums
    # the counter over every main path; None (a shape no path runs) is 0
    paths = {"l336": l336["launches"], "l336_f32": l336_f32, "l14_f32": l14_f32,
             "dyn": dyn["launches"], "fused_qmatmul": dyn_routes[-1],
             "so400m": so400m["launches"], "so400m_bf16": bf16, "so400m_f32": so400m_f32,
             "pe": pe["launches"],
             "pe_f32": pe_f32, "g14": g14, "l336_ln0": routes[0], "l336_wire": routes[1],
             "so400m_wire0": routes[2], "scorer": scorer, **tower_paths,
             "dp_l336": dp["launches"], **tp_paths, **dry_paths}
    # shapes that two paths run: K2's [9232, 1024] on phase 36's shards and
    # phase 37's L-336, K1's 8-head shard in phase 37's int8_static and bf16
    summed = {"l336_parallel": ("dp_l336", "tp_l336"),
              "tp_l336_all": ("tp_l336", "tp_l336_bf16")}
    every = [*paths.values(), *dyn_routes[:-1], pe_bf16, dedup_embed]
    paths.update({name: {k: sum(paths[p][k] for p in parts) for k in paths[parts[0]]}
                  for name, parts in summed.items()})

    def path_launches(path) -> int:
        if path is None:
            return 0
        name, counter = path
        return sum(p[counter] for p in every) if name == "all" else paths[name][counter]

    rows = [dict(r, path=r["path"] and "/".join(r["path"]), launches=path_launches(r["path"]))
            for r in rows]
    check_no_jax()  # the CLI runs of every phase imported no JAX either
    print(json.dumps({"dedup": dedup_records}))
    print(json.dumps({"stages": stage_records}))
    print(json.dumps({"loop": loop_records}))
    print(json.dumps({"native_decoder": decoder}))
    print(json.dumps({"conv_towers": conv_records}))
    print(json.dumps({"parallel": parallel_records}))
    print(json.dumps({"tools": tool_records}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
