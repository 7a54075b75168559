// Head-grouped packed multi-head attention (K4) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel _packed_grouped_kernel /
// fused_attention_packed_grouped (clip_assisted_data_labeling_tpu/ops/
// attention.py, pallas_call at :342), which the JAX package runs wherever the
// whole [S, 3w] block of one batch item overflows its VMEM budget but a
// 128-lane group of heads fits: PE-Core-G14-448 (S=1024, w=1536, d=96) in
// bf16, and the float32 runs of the 336/384-pixel towers (ViT-L-14-336,
// PE-Core-L14-336, ...). It computes the same arithmetic as K1, for qkv
// packed [B, S, 3w] read in place (the TPU wrapper's [B, 3, S, w] transpose
// is a TPU tiling device and has no counterpart here):
//   q' = rot(T(q * T(scale)))   q scaled in the input type T, then rotated
//   k' = rot(k)                 (rotation only with RoPE tables: the
//                               half-split pairs (i, i + d/2), each product
//                               and then the sum rounded to T, as
//                               attention_common.cuh rot_pair)
//   s  = q' k'^T                float32 accumulation; keys >= s_real get -inf
//   p  = exp(s - max_row(s))    float32, the exact two-pass softmax; the sum
//                               over the unrounded p
//   o  = T((T(p) v) * (1/sum))  P rounded to v's type, float32 accumulation
//
// What bounds it on the H100: at PE-G14-448's shape ([16, 1024, 4608] bf16,
// 16 heads, d=96) the work is 4·B·H·S²·d = 103 GFLOP (0.104 ms at
// 989 TFLOP/s) against B·S·4w·2 = 201 MB (0.060 ms at 3.35 TB/s): the
// tensor-core rate. In float32 the products are 3xTF32 splits (three TF32
// mmas each, attention_common.cuh), bound by the TF32 rate over three (~165
// TFLOP/s). What Hopper has to add to the TPU kernel is any sequence length
// at any head dim up to 128 in both types: a whole score row does not fit
// shared memory beside its operands for long sequences.
//
// The design answers that by streaming the keys through shared memory in
// 64-key chunks (32 in float32) in both passes of the exact softmax, so
// nothing grows with S: pass 1 takes each row's max over all chunks; pass 2
// recomputes the same scores chunk by chunk (the same operations on the same
// data, so the same values), exponentiates against the final max, sums the
// float32 p, and accumulates T(p)·V; the epilogue multiplies by 1/sum.
//
// bfloat16: exact_wgmma_kernel<DP, false, WIRE_BF16, bf16> of
// attention_common.cuh, the template K1, K3, K5, K7 and K10 instantiate
// too: one block of two warpgroups per (128 query rows, head, batch item);
// K and V in 64-key chunks by cp.async into a three-stage ring of 8x8 core
// matrices; Q·K^T on wgmma with K from shared memory, P·V with P in
// registers and V MN-major through the transpose bit. With RoPE, a pre-pass
// (rope_prepass_kernel, in
// the same launch of the C entry) writes q·T(scale) rotated and k rotated
// once into a [B, S, 2w] scratch that the wrapper allocates, with K1's
// staging code (scale8, rot8), so the values are those K1 rotates; the
// kernel then reads q and k from there. Rotated as it is staged, each key
// would be rotated 2·S/128 times (16 at S=1024) between two barriers. The
// pre-pass moves ~100 MB each way at [16, 1024, 4608] (its cost: PERF.md
// §6). Why wgmma and not mma.sync: an mma.sync version with ldmatrix
// (.trans for V) and the same ring ran about as fast on the H100 (PERF.md
// §6), but only wgmma reaches the full tensor-core rate, so the schedule
// that pipelines the warpgroups builds on this one.
//
// float32: exact_3xtf32_kernel<DP, 8, false> of attention_common.cuh, K1's
// float32 kernel with 128 query rows a block: both products as 3xTF32 m16n8k8 mmas
// (a float32 operand split into a rounded TF32 high part and a TF32
// remainder, three mmas per product pair, ~21 of the 24 bits kept), P kept
// in float32. Each K and V chunk comes in by 16-byte cp.async (the next
// one's copy in flight while the warps multiply) and is split once for the
// block, k rotated first. Shared memory stays at 52 KB (d=64) to 101 KB
// (d=128), 8 to 16 KB more with RoPE tables, for any S.

#include "attention_common.cuh"

namespace {

constexpr int DMAX = 128;  // largest head dim

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. cos, sin: RoPE tables [S, d/2] of the
// same dtype (half-split pairs), or both null for no rotation. scratch: with
// bf16 RoPE tables, [B, S, 2w] bf16 for the rotated q and k (else unread).
// Returns cudaGetLastError() of the launch.
int packed_attention_grouped(const void* qkv, void* out, int dtype, int B, int S, int s_real,
                             int w, int heads, float scale, const void* cos, const void* sin,
                             void* scratch, void* stream) {
  if (heads <= 0 || w % heads != 0 || w / heads > DMAX || s_real < 1 || s_real > S ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (w / heads) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32_3xtf32<8>(packed_heads<float>(qkv, out, S, w, w / heads), B, S, s_real,
                                heads, w / heads, scale, cos, sin, st);
  if (dtype == 1)
    return launch_bf16_wgmma<false>(packed_heads<__nv_bfloat16>(qkv, out, S, w, w / heads), B,
                                    S, s_real, heads, w / heads, scale, cos, sin, scratch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
